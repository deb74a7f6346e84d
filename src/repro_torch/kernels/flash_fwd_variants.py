"""Time variants of the wgmma flash forward side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_fwd_variants    # one NVIDIA GPU

Each variant is ``csrc/flash_attention_wgmma.cu`` with one design choice
changed, built by ``nvcc`` into a library of its own under ``build/`` and
called through the same C entry as the shipped kernel.  All are timed in
turns (a, b, ..., b, a: CUDA events around 20 calls each) on qwen2-1.5b's
attention (B = 1, S = 4096, 12 query heads, 2 kv heads, Dh = 128, causal)
and h2o-danube-3-4b's (32/8 heads, Dh = 120, S = 8192, window 4096), in
bf16, beside the first tensor-core kernel (``flash_attention_mma_v1``),
SDPA (``enable_gqa``; danube's with its explicit window mask), ptxas's
registers and spills of each variant's DP = 128 kernel, and each
variant's readings against the plain version and against the first
tensor-core kernel under ``chip_smoke.py``'s bf16 limits (≤ 1 passes).
The overlap variants issue a tile's Q·Kᵀ beside the previous tile's P·V
and run the softmax while the tensor cores work (FlashAttention-3's
intra-warpgroup pipelining); the probe "no lo term" rounds P once to bf16:
it gives outputs the attention check may refuse and sizes what the hi + lo
split costs, for a later accuracy contract.  Nothing in the port calls
this module.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
import subprocess
import sys

import torch

from . import _build
from . import flash_attention as _fa
from . import ref as _ref

SHAPES = {  # label: (B, S, H, KV, Dh, window)
    "qwen2-1.5b": (1, 4096, 12, 2, 128, None),
    "h2o-danube-3-4b": (1, 8192, 32, 8, 120, 4096),
}

_STAGES = "static constexpr int kStages = DP == 128 ? 2 : 3;"
_BK = "constexpr int kBK = 128;"
_SPLIT = "constexpr bool kSplit = true;"
_LOOP = """    for (int it = 0;; ++it) {
      const int s = it % kStages, parity = (it / kStages) & 1;
      mbar_wait(bar_full_k(s), parity);
      if (tile_s[s] < 0) break;
      wg_fence();
      issue_s(s);
      wg_wait<0>();
      fence_regs(sc);
      float corr0, corr1;
      softmax(s, corr0, corr1);
      rescale_o(corr0, corr1);
      split_p();
      mbar_wait(bar_full_v(s), parity);
      fence_all();
      issue_pv(s);
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_empty(s));
    }
"""
# FlashAttention-3's intra-warpgroup overlap: tile i's Q·Kᵀ and tile i - 1's P·V issued together, the softmax of
# tile i run while P·V is on the tensor cores, O rescaled once that P·V is done; the first tile peeled off so that
# no product is issued on a path only some iterations take (ptxas serialises every wgmma otherwise)
_OVERLAP = """    // the next tile's Q K^T and this tile's P V run on the tensor cores while the softmax runs
    // the first tile alone, so that no product is issued on a path only some iterations take
    mbar_wait(bar_full_k(0), 0);
    if (tile_s[0] >= 0) {
      wg_fence();
      issue_s(0);
      wg_wait<0>();
      fence_regs(sc);
      float corr0, corr1;
      softmax(0, corr0, corr1);
      split_p();
      int it = 1;  // tiles taken; the P of tile it - 1 waits in ph / pl for its P V
      for (;; ++it) {
        const int s = it % kStages, prev = (it - 1) % kStages;
        mbar_wait(bar_full_k(s), (it / kStages) & 1);
        if (tile_s[s] < 0) break;
        mbar_wait(bar_full_v(prev), ((it - 1) / kStages) & 1);
        fence_all();
        issue_s(s);
        issue_pv(prev);
        wg_wait<1>();
        fence_regs(sc);
        softmax(s, corr0, corr1);
        wg_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(bar_empty(prev));
        rescale_o(corr0, corr1);
        split_p();
      }
      const int prev = (it - 1) % kStages;
      mbar_wait(bar_full_v(prev), ((it - 1) / kStages) & 1);
      fence_all();
      issue_pv(prev);
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_empty(prev));
    }
"""
# FlashAttention-3's inter-warpgroup ping-pong: named barriers 4 and 5 hand the tensor cores from one consumer
# warpgroup to the other at each Q·Kᵀ, so that one warpgroup's softmax runs while the other's product does
# (warpgroup 1 lets warpgroup 0 go first; warpgroup 0 takes the last hand-over after the loop)
_PINGPONG = """    if (wg == 1) asm volatile("bar.arrive 4, 256;\\n" ::: "memory");
    for (int it = 0;; ++it) {
      const int s = it % kStages, parity = (it / kStages) & 1;
      mbar_wait(bar_full_k(s), parity);
      if (tile_s[s] < 0) break;
      bar_sync(4 + wg, 256);
      wg_fence();
      issue_s(s);
      if (wg == 0)
        asm volatile("bar.arrive 5, 256;\\n" ::: "memory");
      else
        asm volatile("bar.arrive 4, 256;\\n" ::: "memory");
      wg_wait<0>();
      fence_regs(sc);
      float corr0, corr1;
      softmax(s, corr0, corr1);
      rescale_o(corr0, corr1);
      split_p();
      mbar_wait(bar_full_v(s), parity);
      fence_all();
      issue_pv(s);
      wg_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(bar_empty(s));
    }
    if (wg == 0) bar_sync(4, 256);
"""

# name -> changes applied to the shipped source: (text, replacement)
VARIANTS = {
    "shipped (128-key tiles, 2 K/V stages at DP 128, P as hi + lo)": [],
    "one K/V stage fewer": [(_STAGES, _STAGES.replace("2 : 3", "1 : 2"))],
    "64-key tiles": [(_BK, _BK.replace("128", "64"))],
    "64-key tiles, 3 K/V stages": [(_BK, _BK.replace("128", "64")), (_STAGES, _STAGES.replace("2 : 3", "3 : 4"))],
    "softmax beside the products (overlap)": [(_LOOP, _OVERLAP)],
    "overlap, 64-key tiles, 3 K/V stages": [(_LOOP, _OVERLAP), (_BK, _BK.replace("128", "64")),
                                            (_STAGES, _STAGES.replace("2 : 3", "3 : 4"))],
    "ping-pong of the two consumer warpgroups": [(_LOOP, _PINGPONG)],
    "probe: no lo term (P rounded once; timing only)": [(_SPLIT, _SPLIT.replace("true", "false"))],
}


def _apply(name: str, text: str, changes) -> str:
    for old, new in changes:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old[:60]!r} is not in the source")
        text = text.replace(old, new)
    return text


def build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas summary of its DP = 128 kernel)}, built in parallel."""
    src = (_build._CSRC / "flash_attention_wgmma.cu").read_text()
    out = _build._BUILD / "fwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(_apply(name, src, subs))
        cmd = [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I", str(_build._CSRC), str(cu),
               "-o", str(out / f"v{i}.so")]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, p) in procs.items():
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log[-4000:]}")
        m = re.search(r"flash_wgmma_kernelILi128E.*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n.*?"
                      r"Used (\d+) registers", log)
        ptxas = f"{m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled" if m else "?"
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.repro_flash_attention_wgmma.argtypes = _build.load().repro_flash_attention_wgmma.argtypes
        libs[name] = (lib, ptxas)
    return libs


def _reading(got, want) -> float:
    """The larger of chip_smoke.py's two bf16 readings (elements, rows)."""
    got, want = got.float(), want.float()
    d = got - want
    elem = float((d.abs() / (2e-3 + 1e-2 * want.abs())).max())
    row = float((d.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max()) / 1e-2
    return max(elem, row)


def _ms(fn, reps: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _shape(label: str, B: int, S: int, H: int, KV: int, D: int, window, libs) -> None:
    """Time and read every variant, the first tensor-core kernel and SDPA
    on one shape; print the lines."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16().transpose(1, 2)
    k, v = (torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16().transpose(1, 2) for _ in range(2))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    plain = _ref.gqa_flash_attention(q, k, v, pos, pos, True, window)
    v1 = _fa.flash_attention_mma_v1(q, k, v, pos, pos, window=window)
    outs = {name: torch.empty_like(q, memory_format=torch.contiguous_format) for name in libs}

    def call(lib, out):
        views = (q, k, v, out)
        code = lib.repro_flash_attention_wgmma(
            1, *(t.data_ptr() for t in (q, k, v, pos, pos, out)), None, B, H, KV, S, S, D,
            *(s for t in views for s in t.stride()[:3]), 1, int(window is not None),
            0 if window is None else window, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        _build.check(code, "flash forward variant")

    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(_ms(functools.partial(call, libs[name][0], outs[name])))
    v1_ms = _ms(lambda: _fa.flash_attention_mma_v1(q, k, v, pos, pos, window=window))
    if window is None:
        sdpa = _ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
    else:
        p = pos[0]
        mask = (p[None, :] <= p[:, None]) & (p[None, :] > p[:, None] - window)
        sdpa = _ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True))
    print(f"{label}: B={B} S={S} H={H} KV={KV} Dh={D} window={window}, causal, bf16; first tensor-core kernel "
          f"{v1_ms:.4f} ms, SDPA {sdpa:.4f} ms; reading of the first kernel against plain {_reading(v1, plain):.3f}")
    for name in libs:
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms; reading {_reading(outs[name], plain):.3f} "
              f"against plain, {_reading(outs[name], v1):.3f} against the first kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for name, (_, ptxas) in libs.items():
        print(f"{name}: {ptxas}")
    for label, shape in SHAPES.items():
        _shape(label, *shape, libs)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
