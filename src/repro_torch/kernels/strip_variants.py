"""Time variants of the exact path's two strip kernels side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.strip_variants    # one NVIDIA GPU

Each variant is ``csrc/strip_tiles.cu`` with one setting of its constants
changed, built by ``nvcc`` into a library of its own under ``build/`` and
called through the same C entries as the shipped kernels.  ``strip_dists``
varies its block tile (128 × 128, 64 × 128), its thread tile (8 × 8, 8 × 4,
4 × 4) and its stores (streaming or plain); ``strip_topk`` the 16-byte
loads a lane has in flight (1, 2, 4), how it reads ``alive`` (bytes, or
bits packed into shared memory once a block) and its warps a block (4, 8).
Three probes of the distances give other bits and are timed only: no
root, neither root nor stores (a store no entry takes) and the FMA form (two FP
instructions a feature where the kernel has three).  Library i holds distance
variant i and top-k variant i (the shipped setting where a list is
shorter).  All are timed in turns (a, b, ..., b, a: CUDA events around the
calls) on the exact engine's shapes: the insert's strip (5,376 rows by
32,768 slots, d = 16) and the rebuild's 32,768² square for the distances,
the strip at K = 10 and 100 for the top-k, on a seeded 20-blob mixture
offset by 50 (the stream's) with half the slots live; beside them the
first kernels (``strip_dists_v1``, ``strip_topk_v1``), ``torch.cdist``
and ``torch.topk`` on the masked strip, and ptxas's registers and spills
of each variant's kernels.  Every variant's output is checked bit for bit
against the first kernel's (the probes' results are reported, not
required).  Nothing in the port calls this module.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import dynamic as _dyn

U, NP, DIM = 5376, 32768, 16  # the insert's strip: Bp + rk_cap rows by the slots
TOPK = (10, 100)

_TILE = "constexpr int kBM = 64, kBN = 128;"
_THREAD = "constexpr int kTM = 8, kTN = 4;"
_STREAM = "constexpr bool kStream = false;"
_VEC = "constexpr int kVec = 4;"
_BITS = "constexpr bool kAliveBits = false;"
_WARPS = "constexpr int kTopkWarps = 4;"
_ROOT = "if (c < Np) store1(orow + c, __fsqrt_rn(acc[i][j]));"
_STEP = "  return __fadd_rn(acc, __fmul_rn(diff, diff));"


def _tiles(bm: int, tm: int, tn: int):
    return [(_TILE, f"constexpr int kBM = {bm}, kBN = 128;"), (_THREAD, f"constexpr int kTM = {tm}, kTN = {tn};")]


# name -> changes applied to the shipped source: (text, replacement)
DISTS = {
    "shipped: 64 x 128 block, 8 x 4 thread tile, plain stores": [],
    "64 x 128, 8 x 8": _tiles(64, 8, 8),
    "64 x 128, 4 x 4": _tiles(64, 4, 4),
    "128 x 128, 8 x 8": _tiles(128, 8, 8),
    "128 x 128, 8 x 4": _tiles(128, 8, 4),
    "128 x 128, 4 x 4": _tiles(128, 4, 4),
    "64 x 128, 8 x 4, streaming stores": [(_STREAM, _STREAM.replace("false", "true"))],
    # probes, timing only (other bits): what the root, the stores and the third FP instruction cost
    "probe: no root": [(_ROOT, _ROOT.replace("__fsqrt_rn(acc[i][j])", "acc[i][j]"))],
    "probe: no root, no stores": [(_ROOT, "if (c < Np && acc[i][j] < 0.f) store1(orow + c, acc[i][j]);")],
    "probe: FMA (two FP instructions a feature)": [(_STEP, "  return __fmaf_rn(diff, diff, acc);")],
}
TOPKS = {
    "shipped: 4 float4s a lane, alive as bytes, 4 warps a block": [],
    "1 float4 a lane": [(_VEC, _VEC.replace("4", "1"))],
    "2 float4s a lane": [(_VEC, _VEC.replace("4", "2"))],
    "4 float4s, alive as bits": [(_BITS, _BITS.replace("false", "true"))],
    "2 float4s, alive as bits": [(_VEC, _VEC.replace("4", "2")), (_BITS, _BITS.replace("false", "true"))],
    "1 float4, alive as bits": [(_VEC, _VEC.replace("4", "1")), (_BITS, _BITS.replace("false", "true"))],
    "4 float4s, 8 warps a block": [(_WARPS, _WARPS.replace("4", "8"))],
}


def _apply(name: str, text: str, changes) -> str:
    for old, new in changes:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def _ptxas(log: str, kernel: str) -> str:
    m = re.search(kernel + r".*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
                  log)
    return f"{m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled" if m else "?"


def build() -> list[dict]:
    """One library per pair (distance variant i, top-k variant i), built in
    parallel: [{dists, topk, lib, ptxas, first_dists, first_topk}]; the
    first_* flags mark the library that times each variant."""
    src = (_build._CSRC / "strip_tiles.cu").read_text()
    out = _build._BUILD / "strip_variants"
    out.mkdir(parents=True, exist_ok=True)
    n = max(len(DISTS), len(TOPKS))
    names_d = list(DISTS) + [next(iter(DISTS))] * (n - len(DISTS))
    names_t = list(TOPKS) + [next(iter(TOPKS))] * (n - len(TOPKS))
    jobs = []
    for i, (nd, nt) in enumerate(zip(names_d, names_t)):
        cu = out / f"v{i}.cu"
        cu.write_text(_apply(nt, _apply(nd, src, DISTS[nd]), TOPKS[nt]))
        cmd = [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I", str(_build._CSRC), str(cu),
               "-o", str(out / f"v{i}.so")]
        jobs.append((i, nd, nt, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    main = _build.load()
    libs = []
    for i, nd, nt, p in jobs:
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"variant library {i} failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.repro_strip_dists_tiles_f32.argtypes = main.repro_strip_dists_tiles_f32.argtypes
        lib.repro_strip_topk_tiles_f32.argtypes = main.repro_strip_topk_tiles_f32.argtypes
        ptxas = {"dists": _ptxas(log, "strip_dists_tile_kernel"),
                 "topk K=32": _ptxas(log, "strip_topk_vec_kernelILi32E"),
                 "topk K=128": _ptxas(log, "strip_topk_vec_kernelILi128E")}
        libs.append(dict(dists=nd, topk=nt, lib=lib, ptxas=ptxas, first_dists=i < len(DISTS),
                         first_topk=i < len(TOPKS)))
    return libs


def _ms(fn, reps: int) -> float:
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


def _turns(calls: dict, reps: int) -> dict:
    """{name: [ms, ms]}: every call timed in the order a, b, ..., b, a."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(_ms(calls[name], reps))
    return times


def _check(code: int) -> None:
    _build.check(code, "strip variant")


def main() -> int:
    if not torch.cuda.is_available():
        print("strip_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for v in libs:
        print(f"library: distances {v['dists']!r}, top-k {v['topk']!r}: " + "; ".join(
            f"{k} {s}" for k, s in v["ptxas"].items()))
    dev = torch.device("cuda")
    rng = np.random.default_rng(37)
    centres = rng.normal(scale=3.0, size=(20, DIM))
    X = torch.as_tensor(centres[rng.integers(0, 20, size=NP)] + rng.normal(size=(NP, DIM)) + 50.0,
                        dtype=torch.float32, device=dev)
    ids = torch.as_tensor(rng.choice(NP, size=U, replace=False), dtype=torch.int32, device=dev)
    alive = torch.as_tensor(rng.random(NP) < 0.5, device=dev)
    valid = torch.ones(U, dtype=torch.bool, device=dev)
    rows = X[ids.long()]
    stream = torch.cuda.current_stream().cuda_stream

    # strip_dists: the strip and the square, every variant into one buffer, checked after its first call
    for label, (r, reps) in {"strip 5376 x 32768": (rows, 20), "square 32768 x 32768": (X, 3)}.items():
        n = r.shape[0]
        want = _dyn.strip_dists_v1(r, X)
        out = torch.empty(n, NP, device=dev)
        calls, same = {}, {}
        for v in (v for v in libs if v["first_dists"]):
            calls[v["dists"]] = functools.partial(
                lambda lib: _check(lib.repro_strip_dists_tiles_f32(r.data_ptr(), n, X.data_ptr(), NP, DIM,
                                                                   out.data_ptr(), stream)), v["lib"])
            out.fill_(float("nan"))
            calls[v["dists"]]()
            same[v["dists"]] = bool(torch.equal(out, want))
        calls["first kernel (csrc/dynamic.cu)"] = lambda: _dyn.strip_dists_v1(r, X, out=want)
        if n == U:  # cdist's (U, NP) output; the square's would be a second 4 GiB
            calls["torch.cdist (other bits)"] = lambda: torch.cdist(r, X)
        times = _turns(calls, reps)
        print(f"strip_dists, {label}, d = {DIM}:")
        for name, t in times.items():
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in t)} ms"
                  + (f"; bit for bit the first kernel: {same[name]}" if name in same else ""))
        del want, out
        torch.cuda.empty_cache()

    # strip_topk at K = 10 and 100 on the strip
    D = _dyn.strip_dists(rows, X)
    iota = torch.arange(NP, device=dev)
    masked = torch.where(alive[None, :] & (iota[None, :] != ids[:, None].long()), D, float("inf"))
    for K in TOPK:
        want = _dyn.strip_topk_v1(D, ids, valid, alive, K)
        outs, calls = {}, {}
        for v in (v for v in libs if v["first_topk"]):
            od = torch.empty(U, K, device=dev)
            oi = torch.empty(U, K, dtype=torch.int32, device=dev)
            outs[v["topk"]] = (od, oi)
            calls[v["topk"]] = functools.partial(
                lambda lib, od, oi: _check(lib.repro_strip_topk_tiles_f32(
                    D.data_ptr(), U, NP, ids.data_ptr(), valid.data_ptr(), alive.data_ptr(), K, od.data_ptr(),
                    oi.data_ptr(), stream)), v["lib"], od, oi)
        calls["first kernel (csrc/dynamic.cu)"] = lambda: _dyn.strip_topk_v1(D, ids, valid, alive, K)
        calls["torch.topk on the masked strip"] = lambda: torch.topk(masked, K, dim=1, largest=False)
        for name in outs:
            calls[name]()
        same = {name: all(bool(torch.equal(g, w)) for g, w in zip(out, want)) for name, out in outs.items()}
        times = _turns(calls, 10)
        print(f"strip_topk, strip {U} x {NP}, K = {K}, {int(alive.sum())} live slots:")
        for name, t in times.items():
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in t)} ms"
                  + (f"; bit for bit the first kernel: {same[name]}" if name in same else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
