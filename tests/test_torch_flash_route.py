"""Which flash-attention kernel a CUDA call takes, decided on the CPU.

``repro_torch.kernels.flash_attention.route`` is a pure function of the
dtype, the head width, the views' shapes and strides and their data
pointers: ``"mma"`` (tensor cores, bf16, D ≤ 128 with D % 8 == 0, 16-byte
aligned pointers, strides of axes longer than 1 multiples of 8 elements)
or ``"simt"`` (the CUDA-core kernel, ``csrc/flash_attention_panel.cu``)
for everything else.  ``flash_attention_scalar``, the earlier CUDA-core
kernel kept as the card's oracle of the ``"simt"`` route, takes CUDA
tensors only.  The backward applies the same rule over its eight views
(``backward_route``: ``"mma"`` is ``csrc/flash_attention_bwd_mma.cu``,
``"simt"`` ``csrc/flash_attention_bwd.cu``); its oracle
``flash_attention_backward_simt`` also takes CUDA tensors only.  The kernels run only on a card (tests/test_torch_cuda.py);
the rules are held here.
"""

import pytest
import torch

from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as tops


def _contiguous(B, H, KV, S, D):
    """Shapes and strides of contiguous head-major q, k, v and out."""
    shapes = [(B, H, S, D), (B, KV, S, D), (B, KV, S, D), (B, H, S, D)]
    strides = [(h * S * D, S * D, D, 1) for _, h, _, _ in shapes]
    return shapes, strides


def _route(dtype=torch.bfloat16, D=128, shapes=None, strides=None, ptrs=(0, 4096, 8192, 12288)):
    if shapes is None:
        shapes, strides = _contiguous(1, 12, 2, 64, D)
    return t_fa.route(dtype, D, shapes, strides, ptrs)


@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, "mma"), (torch.float32, "simt"), (torch.float16, "simt"), (torch.float64, "simt")])
def test_dtype(dtype, want):
    assert _route(dtype=dtype) == want


@pytest.mark.parametrize("D,want", [
    (8, "mma"), (16, "mma"), (64, "mma"), (120, "mma"), (128, "mma"),
    (4, "simt"), (12, "simt"), (100, "simt"), (136, "simt"), (256, "simt")])
def test_head_dim(D, want):
    assert _route(D=D) == want


@pytest.mark.parametrize("offset,want", [(0, "mma"), (16, "mma"), (48, "mma"), (2, "simt"), (8, "simt")])
@pytest.mark.parametrize("which", range(4))
def test_pointer_alignment(offset, want, which):
    ptrs = [1 << 20, 2 << 20, 3 << 20, 4 << 20]
    ptrs[which] += offset
    assert _route(ptrs=ptrs) == want


@pytest.mark.parametrize("axis,stride,want", [
    (0, 12 * 64 * 128 + 8, "mma"), (0, 12 * 64 * 128 + 4, "simt"),
    (1, 64 * 128 + 8, "mma"), (1, 64 * 128 + 1, "simt"),
    (2, 136, "mma"), (2, 132, "simt"), (2, 129, "simt")])
def test_strides(axis, stride, want):
    shapes, strides = _contiguous(2, 12, 2, 64, 128)
    strides = [list(s) for s in strides]
    strides[0][axis] = stride
    assert _route(shapes=shapes, strides=strides) == want


def test_axis_of_length_one_is_not_checked():
    shapes, strides = _contiguous(1, 12, 2, 64, 128)
    strides = [list(s) for s in strides]
    strides[0][0] = 3  # B == 1: the batch stride is never used
    assert _route(shapes=shapes, strides=strides) == "mma"
    shapes[0] = (2, 12, 64, 128)
    assert _route(shapes=shapes, strides=strides) == "simt"


@pytest.mark.parametrize("H,KV,D", [(12, 2, 128), (32, 8, 120)])  # qwen2-1.5b, h2o-danube-3-4b
def test_model_layout_views_take_mma(H, KV, D):
    """The views ops.flash_attention hands the wrapper for the two model
    widths chip_smoke.py runs: (B, S, heads, D) transposed to head-major."""
    q = torch.empty(1, 96, H, D, dtype=torch.bfloat16)
    k = torch.empty(1, 96, KV, D, dtype=torch.bfloat16)
    views = [t.transpose(1, 2) for t in (q, k, k.clone(), torch.empty_like(q))]
    args = ([t.shape for t in views], [t.stride() for t in views], [t.data_ptr() for t in views])
    assert t_fa.route(torch.bfloat16, D, *args) == "mma"
    assert t_fa.route(torch.float32, D, *args) == "simt"


def test_cpu_call_counts_no_launch():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 20, h, 16, generator=g).bfloat16() for h in (4, 2, 2))
    before = (t_fa.launches, t_fa.launches_mma, t_fa.launches_simt)
    out = tops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert (t_fa.launches, t_fa.launches_mma, t_fa.launches_simt) == before


@pytest.mark.parametrize("D", [1, 8, 24, 64, 120, 128, 129, 200, 256])
@pytest.mark.parametrize("layout", ["contiguous", "model", "odd stride", "unaligned"])
def test_every_f32_case_takes_simt(D, layout):
    """f32 never reaches the tensor cores, whatever its width, layout or
    alignment."""
    if layout == "contiguous":
        shapes, strides = _contiguous(2, 12, 2, 64, D)
        ptrs = (0, 4096, 8192, 12288)
    else:
        q = torch.empty(2, 64, 12, D + (layout == "odd stride"))[..., :D]
        k = torch.empty(2, 64, 2, D)
        views = [t.transpose(1, 2) for t in (q, k, k.clone(), torch.empty_like(q))]
        shapes, strides = [t.shape for t in views], [t.stride() for t in views]
        ptrs = [t.data_ptr() + 4 * (layout == "unaligned") for t in views]
    assert t_fa.route(torch.float32, D, shapes, strides, ptrs) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_oracle_takes_cuda_tensors_only(dtype):
    """flash_attention_scalar runs the earlier CUDA-core kernel or refuses:
    no plain version for CPU tensors, and no launch counted."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, h, 20, 16, generator=g).to(dtype) for h in (4, 2, 2))
    pos = torch.arange(20, dtype=torch.int32)[None]
    before = (t_fa.launches, t_fa.launches_mma, t_fa.launches_simt, t_fa.launches_scalar)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_fa.flash_attention_scalar(q, k, v, pos, pos)
    assert (t_fa.launches, t_fa.launches_mma, t_fa.launches_simt, t_fa.launches_scalar) == before


def _model_views(H, KV, D, dtype, misaligned=False, B=2, S=48):
    """The eight views ``ops.FlashAttentionFn.backward`` hands
    ``flash_attention_backward``: (B, S, heads, D) tensors transposed to
    head-major (q, k, v, o, dO, dq, dk, dv); with ``misaligned`` dO starts
    one element past an aligned address."""
    q, o, dq = (torch.empty(B, S, H, D, dtype=dtype).transpose(1, 2) for _ in range(3))
    k, v, dk, dv = (torch.empty(B, S, KV, D, dtype=dtype).transpose(1, 2) for _ in range(4))
    n = B * S * H * D
    do = torch.empty(n + misaligned, dtype=dtype)[int(misaligned):].view(B, S, H, D).transpose(1, 2)
    return q, k, v, o, do, dq, dk, dv


@pytest.mark.parametrize("H,KV,D,dtype,misaligned,want", [
    (12, 2, 128, torch.bfloat16, False, "mma"),   # qwen2-1.5b
    (32, 8, 120, torch.bfloat16, False, "mma"),   # h2o-danube-3-4b, Dh 120
    (12, 2, 128, torch.float32, False, "simt"),   # f32
    (12, 2, 256, torch.bfloat16, False, "simt"),  # Dh 256
    (12, 2, 128, torch.bfloat16, True, "simt"),   # a misaligned dO
], ids=["qwen2-1.5b bf16", "danube Dh120 bf16", "qwen2-1.5b f32", "bf16 Dh256", "misaligned dO"])
def test_backward_route_of_model_layout_views(H, KV, D, dtype, misaligned, want):
    """The backward's kernel from the eight views' dtype, shapes, strides
    and data pointers alone: ``backward_route`` is ``route`` over all
    eight."""
    views = _model_views(H, KV, D, dtype, misaligned)
    assert t_fa.backward_route(*views) == want
    args = ([t.shape for t in views], [t.stride() for t in views], [t.data_ptr() for t in views])
    assert t_fa.route(dtype, D, *args) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_simt_oracle_takes_cuda_tensors_only(dtype):
    """flash_attention_backward_simt refuses CPU tensors and counts no
    launch; flash_attention_backward on them takes the plain version."""
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(1, h, 20, 16, generator=g).to(dtype) for h in (4, 2, 2, 4))
    pos = torch.arange(20, dtype=torch.int32)[None]
    lse = torch.empty(1, 4, 20)
    o = t_fa.flash_attention(q, k, v, pos, pos, lse=lse)
    before = (t_fa.launches_bwd, t_fa.launches_bwd_mma, t_fa.launches_bwd_simt)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_fa.flash_attention_backward_simt(q, k, v, o, lse, do, pos, pos)
    grads = t_fa.flash_attention_backward(q, k, v, o, lse, do, pos, pos)
    assert all(g.dtype == dtype and g.shape == t.shape for g, t in zip(grads, (q, k, v)))
    assert (t_fa.launches_bwd, t_fa.launches_bwd_mma, t_fa.launches_bwd_simt) == before
