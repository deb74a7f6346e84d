"""Time variants of the grid Borůvka round's kernel side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.grid_variants    # one NVIDIA GPU

Each variant is ``csrc/grid_round.cu`` with text patches applied (every
patch must match the shipped source exactly once), built by ``nvcc`` into a
library of its own under ``build/`` and called through the same C entry as
the shipped kernel: the ring depth (1, 2, 4 and 8 stages), a 1-D bulk copy
a tile on an mbarrier instead of 16-byte ``cp.async`` copies (d = 16 here:
the tile's rows at stride d), and the label skip (a tile whose valid
columns all carry the block's one live label skips its FMAs; its mask
then keeps nothing).  The cluster size is
the entry's argument: the shipped library also runs at 1, 2, 4 and 8 CTAs
a query block.  Four probes give other bits and are timed only: no
candidate evaluation (no row's best ever falls, so every tile of finite
bound is visited, and the FMAs, their results unused, fall away too), no
merges of the kept columns (again every tile visited), no correctly
rounded roots (w = max(cd_r, cd_c)) and no FMAs (every distance 0); a
fifth keeps the bits and sums each warp's SM clocks by phase of the walk
(the wait and barrier, the copies, the FMAs, the candidates and the vote:
a phase's latency shows in the next phase that waits on it).  The table is
the ``[grid]`` stream's, as ``chip_smoke.py`` builds it (262,144 points of
a seeded 20-blob mixture, d = 16, blocks of 8192, compression 0.02: L =
5,243, Lp = 8192); the rounds are one Borůvka pass's own (labels and
hopeless masks from ``core/mst.py::boruvka_grid``), the working rounds and
one empty round.  Everything is timed in two turns (a, b, ..., b, a: CUDA
events around 20 launches over the round's blocks, queued behind a spin)
beside the first kernel (``grid_round_minima_v1``); every variant's output
is checked bit for bit against the first kernel's (the probes' are
reported, not required), and ptxas's registers, stack and spills of each
variant's d <= 16 kernel are printed.  Nothing in the port calls this
module.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import grid as _grid

SEED, N_POINTS, N_QUERIES, DIM, BLOCK = 20241209 + 1, 262_144, 65_536, 16, 8192  # chip_smoke.py's [grid] data
MIN_PTS, COMPRESSION, EPSILON = 10, 0.02, 0.2
REPS = 20
CLUSTERS = (1, 2, 4, 8)

_STAGES = "constexpr int kStages = 4;"
_UPDATE = "const bool lt = (keep >> c & 1u) && "
_ROOT = "const float w = fmaxf(sqrtf(fmaxf(acc[c], 0.f)), fmaxf(cd_r, cv.z));"
_FMA = "acc[c] = __fmaf_rn(x[f + 3], v.w, acc[c]);"
_FIN = "    if (fin) {\n"
_FIN_END = "      __syncwarp();  // the warp is done with cval before the next visit writes it\n"
_LOOP = "  for (int k = 0;; ++k) {"
_BREAK = "    if (!__syncthreads_or(want)) break;\n"
_STAGE = "    const int s = k % kStages;\n"
_DRAIN = "  repro::cp_async_wait_all();\n"
_TILE_COPY = "    copy_rows(st, a.pts, tile * T, T, Lp, a.d, k0, width, P.sd, vec4);\n"

# a 1-D bulk copy a tile (T·d·4 bytes, d % 4 == 0) completing on the stage's mbarrier; the tile's rows at stride d
_BULK = [
    ("// Start the copies of features", r"""// Wait until the barrier's phase with the given parity has completed; a
// wait that cannot end traps after ~2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Start the copies of features"""),
    ("row stride, slices\n", "row stride, slices\n  int ld;                // tile row stride: dp where a tile is one bulk copy\n"),
    ("cval, bytes;", "cval, bars, bytes;"),
    ("    stage_floats = (size_t)kMaxTile * sd",
     "    ld = d % 4 == 0 && sn == 1 && dp == d ? dp : sd;\n    stage_floats = (size_t)kMaxTile * ld"),
    ("    ocol = at;", "    bars = at;\n    at += 8 * kStages;\n    ocol = at;"),
    ("  int* fe = reinterpret_cast<int*>(smem + P.fe);\n",
     "  int* fe = reinterpret_cast<int*>(smem + P.fe);\n"
     "  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + P.bars);\n"),
    (_TILE_COPY, "    if (P.ld != P.sd) {\n      if (tid == 0)\n"
                 "        bulk_copy(st, a.pts + (size_t)tile * T * a.d, static_cast<uint32_t>(sizeof(float) * T * a.d),\n"
                 "                  smem_u32(bars + q % kStages));\n    } else {\n  " + _TILE_COPY + "    }\n"),
    ("  if (gw) {\n    for (int q = 0; q <= kAhead; ++q) {",
     "  if (tid == 0 && P.ld != P.sd) {\n"
     "    for (int s = 0; s < kStages; ++s)\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\\n\" ::\"r\"(smem_u32(bars + s)) : \"memory\");\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\");\n  }\n"
     "  if (gw) {\n    for (int q = 0; q <= kAhead; ++q) {"),
    (_LOOP, "  int stop = 0;  // the first iteration not consumed\n" + _LOOP),
    (_BREAK, "    if (!__syncthreads_or(want)) {\n      stop = k;\n      break;\n    }\n"),
    (_STAGE, _STAGE + "    if (P.ld != P.sd) mbar_wait(smem_u32(bars + s), (k / kStages) & 1);\n"),
    ("st + min(lane, kMaxTile - 1) * P.sd", "st + min(lane, kMaxTile - 1) * P.ld"),
    ("st + c * P.sd + f0", "st + c * P.ld + f0"),
    # the bulk copies started past the stop point land before the CTA leaves
    (_DRAIN, _DRAIN + "  if (P.ld != P.sd && tid == 0) {\n"
                      "    for (int q = stop; q < stop + kAhead; ++q)\n"
                      "      if (hdr_t[q % kHdr] >= 0) mbar_wait(smem_u32(bars + q % kStages), (q / kStages) & 1);\n"
                      "  }\n"),
]
# a tile whose valid columns all carry the block's one live label skips its FMAs: no live row keeps a column of it
_LABEL_SKIP = [
    ("  // Iteration q: visit q / sn", """  // a live row's label, then whether every live row carries it
  long long* seen = reinterpret_cast<long long*>(smem + P.labc);
  if (tid == 0) *seen = LLONG_MIN;
  __syncthreads();
  if (live)
    atomicCAS(reinterpret_cast<unsigned long long*>(seen), (unsigned long long)LLONG_MIN, (unsigned long long)lab_r);
  __syncthreads();
  const long long one_label = *seen;
  const bool one = !__syncthreads_or(live && lab_r != one_label);
  // Iteration q: visit q / sn"""),
    ("    // the slice's features:",
     "    const bool skip = fin && sn == 1 && one && !__syncthreads_or(lane < T && ocol[s * kMaxTile + lane] >= 0 &&\n"
     "                                                                 labc[s * kMaxTile + lane] != one_label);\n"
     "    // the slice's features:"),
    ("f0 < width; f0 += KS", "!skip && f0 < width; f0 += KS"),
]
# each warp's SM clocks summed by phase of the walk into visits[2 .. 5]: the wait and barrier, the copies and the
# gather warp's loads, the FMAs, the candidates and the vote
_CLOCKS = [
    (_LOOP, "  long long clk[4] = {0, 0, 0, 0}, tick = clock64();\n"
            "  auto mark = [&](int phase) {\n    const long long now = clock64();\n"
            "    clk[phase] += now - tick;\n    tick = now;\n  };\n" + _LOOP),
    (_BREAK, _BREAK + "    mark(0);\n"),
    (_STAGE, "    mark(1);\n" + _STAGE),
    (_FIN, "    mark(2);\n" + _FIN),
    ("    col0 = col1;\n", "    col0 = col1;\n    mark(3);\n"),
    (_DRAIN, "  if (lane == 0 && a.visits != nullptr) {\n"
             "    for (int i = 0; i < 4; ++i) atomicAdd(a.visits + 2 + i, (unsigned long long)clk[i]);\n  }\n" + _DRAIN),
]

# name -> changes applied to the shipped source: (text, replacement)
VARIANTS = {
    "shipped: 4 stages, 16-byte cp.async, no label skip": [],
    "1 stage": [(_STAGES, _STAGES.replace("4", "1"))],
    "2 stages": [(_STAGES, _STAGES.replace("4", "2"))],
    "8 stages": [(_STAGES, _STAGES.replace("4", "8"))],
    "bulk copies": _BULK,
    "label skip": _LABEL_SKIP,
    # probes, timing only (other bits): what the candidates, their roots and the FMAs cost
    "probe: no candidate evaluation": [(_FIN, _FIN + "      if (false) {\n"), (_FIN_END, _FIN_END + "      }\n")],
    "probe: no merges": [(_UPDATE, "const bool lt = a.Lp < 0 && (keep >> c & 1u) && ")],
    "probe: no roots": [(_ROOT, "const float w = fmaxf(cd_r, cv.z);")],
    "probe: no FMAs": [(_FMA, _FMA + " acc[c] = 0.f;")],
    # the shipped bits, with each warp's SM clocks summed by phase of the walk
    "probe: phase clocks": _CLOCKS,
}
PHASES = ("wait and barrier", "copies and the gather warp", "FMAs", "candidates and the vote")


def _apply(name: str, text: str, changes) -> str:
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is in the source {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def _ptxas(log: str) -> str:
    """Registers, stack and spills of the d <= 16 instantiation."""
    m = re.search(r"grid_round_tiles_kernelILi16E.*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n"
                  r".*?Used (\d+) registers", log)
    return f"{m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled" if m else "?"


def build() -> list[dict]:
    """One library per variant, built in parallel: [{name, lib, ptxas}]."""
    src = (_build._CSRC / "grid_round.cu").read_text()
    out = _build._BUILD / "grid_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, changes) in enumerate(VARIANTS.items()):
        cu = out / f"v{i}.cu"
        cu.write_text(_apply(name, src, changes))
        cmd = [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I", str(_build._CSRC), str(cu),
               "-o", str(out / f"v{i}.so")]
        jobs.append((i, name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    main = _build.load()
    libs = []
    for i, name, p in jobs:
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"variant library {i} failed to build:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"v{i}.so"))
        lib.repro_grid_round_tiles_f32.argtypes = main.repro_grid_round_tiles_f32.argtypes
        libs.append(dict(name=name, lib=lib, ptxas=_ptxas(log)))
    return libs


def stream_table(dev):
    """The [grid] stream's table after its full flush: the engine's
    representatives, extents and masses (chip_smoke.py's [stream] data)."""
    from .. import StreamingClusterEngine

    rng = np.random.default_rng(SEED)
    n = N_POINTS + N_QUERIES  # drawn with the queries, as chip_smoke.py draws them
    centres = rng.normal(scale=3.0, size=(20, DIM))
    X = (centres[rng.integers(0, 20, size=n)] + rng.normal(size=(n, DIM)) + 50.0)[:N_POINTS]
    eng = StreamingClusterEngine(DIM, min_pts=MIN_PTS, compression=COMPRESSION, epsilon=EPSILON, max_block=BLOCK,
                                 device=dev, spatial_index=True)
    for i in range(0, N_POINTS, BLOCK):
        eng.ingest(X[i : i + BLOCK])
    eng.flush()
    return eng._table.capture(eng.tree.n_points).table()


def pass_rounds(dev, table):
    """The padded table's grid, visit lists and core distances, and every
    round's (labels, hopeless) of one Borůvka pass over them."""
    from ..core.mst import boruvka_grid
    from . import ops

    rep, extent, n_b, _ = table
    L, d = rep.shape
    (rep_t, nb_t, ext_t), mp, _ = ops._prepare_table(rep, n_b, extent, MIN_PTS, dev)
    grid, views = ops._grid_table(rep_t, L)
    cd = _grid.grid_core_distances(grid, nb_t, ext_t, mp, d, views)
    search, rounds = _grid.grid_round_minima, []

    def hook(g, v, cd_, labels, hopeless, blocks=None):
        rounds.append((labels.clone(), hopeless.clone()))
        return search(g, v, cd_, labels, hopeless, blocks=blocks)

    _grid.grid_round_minima = hook
    try:
        boruvka_grid(grid, cd, views)
    finally:
        _grid.grid_round_minima = search
    return grid, views, cd, rounds


def _ms(fn) -> float:
    """Device ms of one call: CUDA events around REPS calls queued behind a
    ~2 ms spin, so that an empty round's launches are timed on the device
    and not at the host's enqueue rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def _turns(calls: dict) -> dict:
    """{name: [ms, ms]}: every call timed in the order a, b, ..., b, a."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(_ms(calls[name]))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("grid_variants: no CUDA device", file=sys.stderr)
        return 2
    libs = build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    for v in libs:
        print(f"library {v['name']!r}: {v['ptxas']}")
    dev = torch.device("cuda")
    grid, views, cd, rounds = pass_rounds(dev, stream_table(dev))
    Lp, d = grid.pts.shape
    if grid.pts.data_ptr() % 16:
        raise RuntimeError("the bulk-copy variant wants a 16-byte aligned table")
    NB, NT = views.order.shape
    stream = torch.cuda.current_stream().cuda_stream
    working = [i for i, (_, h) in enumerate(rounds) if bool((grid.valid & ~h[grid.orig.long()]).any())]
    empty = [i for i in range(len(rounds)) if i not in working][:1]
    print(f"table L = {int(grid.n_valid)}, Lp = {Lp}, d = {d}: {NB} blocks x {NT} tiles; {len(rounds)} rounds, "
          f"working {[i + 1 for i in working]}")
    for i in working + empty:
        labels, hopeless = rounds[i]
        args = (grid, views, cd, labels, hopeless, (0, NB))
        want = _grid.grid_round_minima_v1(*args)
        outs, calls = {}, {}
        for v in libs:
            w = torch.empty(NB * 64, device=dev)
            e = torch.empty(NB * 64, dtype=torch.int32, device=dev)
            outs[v["name"]] = (w, e)

            def call(lib=v["lib"], w=w, e=e, c=_grid.ROUND_CLUSTER):
                _build.check(lib.repro_grid_round_tiles_f32(
                    *_grid._grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), NT, cd.data_ptr(),
                    labels.data_ptr(), hopeless.data_ptr(), 0, NB, c, w.data_ptr(), e.data_ptr(), None, stream),
                    "grid round variant")

            calls[v["name"]] = call
            if v is libs[0]:
                for c in CLUSTERS:
                    calls[f"shipped at cluster {c}"] = lambda c=c: _grid.grid_round_minima(*args, cluster=c)
        for name in outs:
            calls[name]()
        clocks = next(v for v in libs if v["name"] == "probe: phase clocks")
        counters = torch.zeros(2 + len(PHASES), dtype=torch.int64, device=dev)
        w, e = outs[clocks["name"]]
        _build.check(clocks["lib"].repro_grid_round_tiles_f32(
            *_grid._grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), NT, cd.data_ptr(),
            labels.data_ptr(), hopeless.data_ptr(), 0, NB, _grid.ROUND_CLUSTER, w.data_ptr(), e.data_ptr(),
            counters.data_ptr(), stream), "grid round variant")
        split = counters[2 : 2 + len(PHASES)].double().cpu().numpy()
        same = {name: bool(torch.equal(w, want[0]) and torch.equal(e, want[1])) for name, (w, e) in outs.items()}
        for c in CLUSTERS:
            got = _grid.grid_round_minima(*args, cluster=c)
            same[f"shipped at cluster {c}"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        calls["first kernel (csrc/grid.cu)"] = lambda: _grid.grid_round_minima_v1(*args)
        times = _turns(calls)
        live = int((grid.valid & ~hopeless[grid.orig.long()]).sum())
        print(f"round {i + 1}, {live} live rows (libraries at cluster {_grid.ROUND_CLUSTER}):")
        for name, t in times.items():
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in t)} ms"
                  + (f"; bit for bit the first kernel: {same[name]}" if name in same else ""))
        if split.sum() > 0:
            print(f"  the walk's SM clocks by phase, all warps (rows x tiles visited {int(counters[0])}, longest walk "
                  f"{int(counters[1])}): " + ", ".join(f"{p} {c / split.sum():.3f}" for p, c in zip(PHASES, split))
                  )
        bad = [n for n, ok in same.items() if not ok and not n.startswith("probe")]
        if bad:
            print(f"grid_variants: not bit for bit the first kernel: {bad}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
