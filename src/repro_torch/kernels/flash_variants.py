"""Time variants of the CUDA-core flash kernel side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_variants    # one NVIDIA GPU

Each variant is ``csrc/flash_attention_panel.cu`` with one design choice
undone, built by ``nvcc`` into a library of its own under ``build/`` and
called through the same C entry as the shipped kernel.  All are timed in
turns (a, b, ..., b, a: CUDA events around 5 calls each) on qwen2-1.5b's
attention in f32 (B = 1, S = 4096, 12 query heads, 2 kv heads, Dh = 128,
causal), beside ptxas's registers and spills of each variant's f32
DP = 128 kernel.  The "probe" variants read only a quarter of one
operand's shared loads and give wrong outputs: they show what those
loads cost, nothing else.  Nothing in the port calls this module.
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys

import torch

from . import _build

SHAPE = (1, 4096, 12, 2, 128)  # B, S, H, KV, Dh

_Q = "for (int a = 0; a < 4; ++a) qa[a] = *reinterpret_cast<const float4*>(qrow + 4 * a * kSQ + d);"
_K = "for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(krow + 8 * j * kSQ + d);"
_V = "const float4 w = *reinterpret_cast<const float4*>(vrow + kk * kSV + 32 * u);"
_WARPS = "static constexpr int kWarps = DP <= 128 ? 12 : 4;"
_BOUNDS = "__launch_bounds__(Layout<DP>::kThreads, 1)"
_STAGE16 = "#pragma unroll 1  // unrolled,"

# name -> (source text, replacement) pairs applied to the shipped source
VARIANTS = {
    "shipped (12 warps, 1 block/SM)": [],
    "8 warps, 1 block/SM": [(_WARPS, "static constexpr int kWarps = DP <= 128 ? 8 : 4;")],
    "4 warps, 2 blocks/SM": [(_WARPS, "static constexpr int kWarps = 4;"),
                             (_BOUNDS, "__launch_bounds__(Layout<DP>::kThreads, DP == 128 ? 2 : 1)")],
    "PV skips column groups past D": [("        for (int u = 0; u < kNC; ++u) {\n          const float4 w",
                                       "        for (int u = 0; u < kNC; ++u) {\n          if (32 * u >= g.D) break;\n"
                                       "          const float4 w")],
    "16-byte staging unrolled": [(_STAGE16, "#pragma unroll  //")],
    "probe: 1/4 of the K loads": [(_K, "kb[0] = *reinterpret_cast<const float4*>(krow + d); kb[1] = kb[2] = kb[3] = kb[0];")],
    "probe: 1/4 of the Q loads": [(_Q, "qa[0] = *reinterpret_cast<const float4*>(qrow + d); qa[1] = qa[2] = qa[3] = qa[0];")],
    "probe: 1/4 of the V loads": [(_V, "const float4 w = *reinterpret_cast<const float4*>(vrow + kk * kSV);")],
}


def build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas summary of its f32 DP = 128 kernel)}, built in parallel."""
    src = (_build._CSRC / "flash_attention_panel.cu").read_text()
    out = _build._BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
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
        m = re.search(r"flash_panel_kernelIfLi128E.*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n"
                      r".*?Used (\d+) registers", log)
        ptxas = f"{m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled" if m else "?"
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_flash_attention_panel.argtypes = [I, P, P, P, P, P, P, P] + [I] * 6 + [LL] * 12 + [I, I, I,
                                                                                          ctypes.c_float, P]
        libs[name] = (lib, ptxas)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build()
    B, S, H, KV, D = SHAPE
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(B, h, S, D, generator=gen, device=dev) for h in (H, KV, KV))
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    shipped = torch.empty_like(q)

    def call(lib, out):
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        code = lib.repro_flash_attention_panel(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                                               pos.data_ptr(), out.data_ptr(), None, B, H, KV, S, S, D, *strides, 1,
                                               0, 0, 1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
        _build.check(code, "flash_attention variant")

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

    call(libs[next(iter(VARIANTS))][0], shipped)
    outs = {name: torch.empty_like(q) for name in libs}
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(ms(libs[name][0], outs[name]))
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; qwen2-1.5b attention in f32, B={B} S={S} H={H} KV={KV} Dh={D}, causal")
    for name, (_, ptxas) in libs.items():
        err = float((outs[name] - shipped).abs().max())
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms; {ptxas}; max |out - shipped| {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
