"""Time variants of the tensor-core flash backward side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_bwd_variants    # one NVIDIA GPU

Each variant is ``csrc/flash_attention_bwd_mma.cu`` with one design choice
changed, built by ``nvcc`` into a library of its own under ``build/`` and
called through the same C entry as the shipped kernel.  All are timed in
turns (a, b, ..., b, a: CUDA events around 5 calls each) on qwen2-1.5b's
attention (B = 1, S = 8192, 12 query heads, 2 kv heads, Dh = 128, causal)
and h2o-danube-3-4b's (32/8 heads, Dh = 120, window 4096), in bf16,
beside ptxas's registers and spills of each variant's DP = 128 dK/dV and
dQ kernels and each variant's reading against the CUDA-core kernel
(``flash_attention_backward_simt``) under ``chip_smoke.py``'s bf16 limits
(2^-7 of each |value| plus 1e-3 of the tensor's root mean square; ≤ 1
passes).  Nothing in the port calls this module.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys

import torch

from . import _build
from . import flash_attention as _fa

SHAPES = {  # label: (B, S, H, KV, Dh, window)
    "qwen2-1.5b": (1, 8192, 12, 2, 128, None),
    "h2o-danube-3-4b": (1, 8192, 32, 8, 120, 4096),
}

_BQ = "static constexpr int kBQ = DP == 128 ? 32 : 64;"
_BK = "static constexpr int kBK = DP == 128 ? 32 : 64;"
_SUBK = "static constexpr int kSubK = DP == 128 ? 32 : 64;"
_SIDE = "dqk<<<gq.n_blocks * gq.BH, kThreads, S::kBytesDq, side->stream>>>"
_TILE = """#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t[4];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t b0, b1;
      ldsm_x2_trans(bk_addr<kStride>(base, r0 + 16 * kk, 2 * dp + h, lane), b0, b1);
      if (kk == 0)
        mma_bf16_first(t, hi[kk], b0, b1);
      else
        mma_bf16(t, hi[kk], b0, b1);
      mma_bf16(t, lo[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) (h ? acc1 : acc0)[e] = __fadd_rn((h ? acc1 : acc0)[e], t[e]);
  }"""
# both n-tiles of a 16-column slice at once: one ldmatrix.x4.trans, eight sums in flight
_TILE_X4 = """  float t[2][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t bt[4];
    const uint32_t addr = smem_u32(base + (r0 + 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * kStride +
                                   16 * dp + ((lane >> 4) << 3));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
                 : "=r"(bt[0]), "=r"(bt[1]), "=r"(bt[2]), "=r"(bt[3]) : "r"(addr));
    if (kk == 0) {
      mma_bf16_first(t[0], hi[kk], bt[0], bt[1]);
      mma_bf16_first(t[1], hi[kk], bt[2], bt[3]);
    } else {
      mma_bf16(t[0], hi[kk], bt[0], bt[1]);
      mma_bf16(t[1], hi[kk], bt[2], bt[3]);
    }
    mma_bf16(t[0], lo[kk], bt[0], bt[1]);
    mma_bf16(t[1], lo[kk], bt[2], bt[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc0[e] = __fadd_rn(acc0[e], t[0][e]);
    acc1[e] = __fadd_rn(acc1[e], t[1][e]);
  }"""
# the running sums kept in the tensor cores' accumulators through the sweep (fails the check: their f32
# sums are not rounded to nearest)
_TILE_RUNNING = """#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t b0, b1;
      ldsm_x2_trans(bk_addr<kStride>(base, r0 + 16 * kk, 2 * dp + h, lane), b0, b1);
      mma_bf16(h ? acc1 : acc0, hi[kk], b0, b1);
      mma_bf16(h ? acc1 : acc0, lo[kk], b0, b1);
    }
  }"""

# name -> changes applied to the shipped source: (text, replacement)
VARIANTS = {
    "shipped (stages of 32 rows, one n-tile a product step, dQ beside dK/dV)": [],
    "dQ after dK/dV on one stream": [(_SIDE, _SIDE.replace("side->stream", "stream"))],
    "two n-tiles a product step": [(_TILE, _TILE_X4)],
    "dK/dV stages of 16 rows": [(_BQ, _BQ.replace("32", "16"))],
    "dQ stages of 64 rows at once": [(_BK, _BK.replace("32", "64")), (_SUBK, _SUBK.replace("32", "64"))],
    "running sums on the tensor cores": [(_TILE, _TILE_RUNNING)],
}


def _apply(name: str, text: str, changes) -> str:
    for old, new in changes:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old[:60]!r} is not in the source")
        text = text.replace(old, new)
    return text


def build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas summary of its DP = 128 kernels)}, built in parallel."""
    src = (_build._CSRC / "flash_attention_bwd_mma.cu").read_text()
    out = _build._BUILD / "bwd_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = _apply(name, src, subs)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I", str(_build._CSRC), str(cu),
               "-o", str(out / f"v{i}.so")]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, p) in procs.items():
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log[-4000:]}")
        parts = []
        for kern in ("dkdv", "dq"):
            m = re.search(rf"flash_bwd_mma_{kern}_kernelILi128E.*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores.*?\n.*?Used (\d+) registers", log)
            parts.append(f"{kern} {m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled"
                         if m else f"{kern} ?")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.repro_flash_attention_bwd_mma.argtypes = _build.load().repro_flash_attention_bwd_mma.argtypes
        libs[name] = (lib, "; ".join(parts))
    return libs


def _reading(got, want) -> float:
    got, want = got.float(), want.float()
    lim = 2.0**-7 * want.abs() + 1e-3 * float(want.square().mean().sqrt())
    return float(((got - want).abs() / lim).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for name, (_, ptxas) in libs.items():
        print(f"{name}: {ptxas}")
    for label, (B, S, H, KV, D, window) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        q, do = (torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16().transpose(1, 2) for _ in range(2))
        k, v = (torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16().transpose(1, 2) for _ in range(2))
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
        lse = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        o = _fa.flash_attention(q, k, v, pos, pos, window=window, lse=lse)
        simt = _fa.flash_attention_backward_simt(q, k, v, o, lse, do, pos, pos, window=window)
        delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        grads = {name: [torch.empty_like(t) for t in (q, k, v)] for name in libs}

        def call(lib, out):
            views = (q, k, v, o, do, *out)
            code = lib.repro_flash_attention_bwd_mma(
                1, *(t.data_ptr() for t in (q, k, v, o, do, pos, pos, lse, delta, *out)), B, H, KV, S, S, D,
                *(s for t in views for s in t.stride()[:3]), 1, int(window is not None),
                0 if window is None else window, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
            _build.check(code, "flash backward variant")

        def ms(lib, out, reps=5):
            for _ in range(2):
                call(lib, out)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                call(lib, out)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps

        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            times[name].append(ms(libs[name][0], grads[name]))
        print(f"{label}: B={B} S={S} H={H} KV={KV} Dh={D} window={window}, causal, bf16")
        for name in libs:
            reading = max(_reading(g, w) for g, w in zip(grads[name], simt))
            print(f"  {name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms; reading {reading:.3f} against "
                  f"the CUDA-core kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())
