"""Time variants of the grid's round, assign and Eq. 6 kernels side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.grid_variants             # all three, one NVIDIA GPU
    PYTHONPATH=src python -m repro_torch.kernels.grid_variants assign      # or round, or cd: some of them

**The Borůvka round** (``csrc/grid_round.cu``).
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
variant's d <= 16 kernel are printed.

**The assign kernel** (``csrc/grid_assign.cu``), the same way: the ring
depth (1, 2, 4 and 8 stages), the cluster size (the entry's argument, 1, 2,
4 and 8), the stop and the candidate filter on each CTA's own bests, and
the filter alone on them (the shipped kernel stops and filters on the
cluster's bests, which each CTA publishes in its shared memory and its
peers read through distributed shared memory without a barrier), 6 CTAs an
SM at up to 168 registers (8 at 128 shipped), and a probe that keeps the
bits and sums each warp's SM clocks by phase (the wait and barrier, the
copies and the header, the FMAs, the candidates and the vote).  Two shapes
on the same table: the ingest shape (the stream's first 8192 points, centred
by the representatives' mean as the engine's ingest centres them) and the
query shape (4096 of the held-out queries, centred the same way), each
timed on its Morton-sorted queries and visit lists beside the first kernel
(``grid_assign_v1``), every variant bit for bit the first kernel's idx and
dist, with the row-tile visits and the longest walk of a CTA.

**The Eq. 6 kernel** (``csrc/grid_cd.cu``), the same way, on the stream's
table as the offline pass pads it (Lp = 8192, its own rows as 128 query
blocks).  At min_pts 10 (the register route, k = 10): the ring depth (1,
2, 4 and 8 stages), the cluster size (1, 2, 4 and 8), the stop on each
CTA's own k-th and on the cluster's least k-th alone (the shipped kernel
stops on the least of the cluster's k-th and its largest j-th, j = ceil(k
/ C), which each CTA publishes in its shared memory and its peers read
through distributed shared memory), the warp-select route forced at k = 10
(the register route's cap set to 0), the register list at 16 and 32
slots (12 shipped up to k = 12, 16 to 16), and two probes that keep the bits: the kept columns
and list inserts of every row, and each warp's SM clocks by phase of the
walk.  At min_pts 13 and 16 (the register route's 16-slot list): the
shipped kernel against the warp-select route forced there.  At min_pts 17, 64, 100
and 2000 (the warp-select route: queues of 32 and 64 in one pass, 128 in
two, two rounds of 1024 in eight passes): the cluster sizes, the stop on
the cluster's bound (the shipped route stops each CTA on its own k-th) and
a walk split over up to 8 CTAs (the shipped route gives the cluster's CTAs
the passes first and splits a walk over at most 2).  Everything beside
the first kernel (``grid_core_distances_v1``), bit for bit its output, with
the row-tile visits and the longest walk of a CTA.

Nothing in the port calls this module.
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
QUERY_SHAPE = 4096  # the serve plane's query chunk
REPS = 20
CLUSTERS = _grid.CLUSTERS

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
    ("struct Args {\n", r"""// Wait until the barrier's phase with the given parity has completed; a
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

struct Args {
"""),
    # the stages keep their size: a tile's rows at stride ld <= sd
    ("cval, bytes;", "cval, bars, bytes;\n  int ld;  // tile row stride: dp where a tile is one bulk copy"),
    ("    ocol = at;", "    ld = d % 4 == 0 && sn == 1 && dp == d ? dp : sd;\n    bars = at;\n    at += 8 * kStages;\n    ocol = at;"),
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

# csrc/grid_assign.cu shares the round's anchors _STAGES, _LOOP, _BREAK, _STAGE, _FIN and _DRAIN; its own:
_A_END = "    if constexpr (kAhead > 0) repro::cp_async_commit();\n  }\n"
_A_SHARED = ("      if (C > 1 && want) {  // the cluster's best: the stop, and the filter of the next visits\n"
             "        const float cb = cluster_best(bs);\n        want = nl <= cb;\n        thr = cb;\n      }\n")
# the stop and the filter on each CTA's own bests (its peers' published bests never read)
_A_OWN_STOP = [(_A_SHARED, "")]
# the stop on the cluster's bests, the filter on the CTA's own
_A_OWN_FILTER = [("        thr = cb;\n", "")]
# each warp's SM clocks summed by phase of the walk into visits[2 .. 5]
_A_CLOCKS = [
    (_LOOP, "  long long clk[4] = {0, 0, 0, 0}, tick = clock64();\n"
              "  auto mark = [&](int phase) {\n    const long long now = clock64();\n"
              "    clk[phase] += now - tick;\n    tick = now;\n  };\n" + _LOOP),
    (_BREAK, _BREAK + "    mark(0);\n"),
    (_STAGE, "    mark(1);\n" + _STAGE),
    (_FIN, "    mark(2);\n" + _FIN),
    (_A_END, _A_END.replace("  }\n", "    mark(3);\n  }\n")),
    (_DRAIN, "  if (lane == 0 && a.visits != nullptr) {\n"
               "    for (int i = 0; i < 4; ++i) atomicAdd(a.visits + 2 + i, (unsigned long long)clk[i]);\n  }\n"
               + _DRAIN),
]
ASSIGN_VARIANTS = {
    "shipped: 4 stages, 16-byte cp.async, stop and filter on the cluster's bests": [],
    "1 stage": [(_STAGES, _STAGES.replace("4", "1"))],
    "2 stages": [(_STAGES, _STAGES.replace("4", "2"))],
    "8 stages": [(_STAGES, _STAGES.replace("4", "8"))],
    "stop and filter on each CTA's own bests": _A_OWN_STOP,
    "filter on each CTA's own bests": _A_OWN_FILTER,
    # room for more values in registers: 6 CTAs an SM at <= 168 registers instead of 8 at 128
    "6 CTAs an SM": [("__launch_bounds__(kThreads, 8)", "__launch_bounds__(kThreads, 6)")],
    # the shipped bits, with each warp's SM clocks summed by phase of the walk
    "probe: phase clocks": _A_CLOCKS,
}
ASSIGN_PHASES = ("wait and barrier", "copies and the header", "FMAs", "candidates and the vote")

# csrc/grid_cd.cu's register route shares the assign kernel's anchors (the ring, the loop, its clocks); its own:
_CD_SHARED = ("      if (C > 1 && want) {  // the cluster's k-th: the stop, and the filter of the next visits\n"
              "        const float cb = fminf(fminf(kd, pk), fmaxf(jd, pj));\n        want = nl <= cb;\n"
              "        thr = sq_cap(cb);\n      }\n")
_CD_READS = "    if (C > 1 && live && last(k)) {  // the peers' bounds for this visit's vote: every load issued, then reduced\n"
# the warp-select route's split walks stop on the cluster's bound, as the register route's do: each CTA publishes
# its rows' k-th and j-th (j = ceil(kq / C)) in its shared memory after every visit, reads its peers' (lane c, peer
# c) at each visit's start, and votes on the least k-th and the largest j-th; reset between rounds
_WS_PEER_STOP = [
    ("struct WsPlan : gw::Slices {\n",
     "// The warp's maximum of a value >= 0 (or +inf).\n"
     "__device__ __forceinline__ float warp_max_nonneg(float v) {\n"
     "  return __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(v) & 0x7fffffffu));\n}\n\n"
     "struct WsPlan : gw::Slices {\n"),
    ("  size_t xs, ys, bneed, blo, lst, bytes;", "  size_t xs, ys, kpub, jpub, bneed, blo, lst, bytes;"),
    ("    bneed = at;\n", "    kpub = at;\n    at += sizeof(float) * kRows;\n    jpub = at;\n"
                        "    at += sizeof(float) * kRows;\n    bneed = at;\n"),
    ("  int* bneed = reinterpret_cast<int*>(smem + P.bneed);\n",
     "  float* kpub = reinterpret_cast<float*>(smem + P.kpub);\n"
     "  float* jpub = reinterpret_cast<float*>(smem + P.jpub);\n"
     "  int* bneed = reinterpret_cast<int*>(smem + P.bneed);\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n  unsigned long long visited = 0;\n",
     "  if (tid < kRows) kpub[tid] = jpub[tid] = inf();\n  cg::cluster_group cluster = cg::this_cluster();\n"
     "  if (C > 1) cluster.sync();  // every CTA's published bounds set before a peer reads them\n"
     "  unsigned long long visited = 0;\n"),
    ("      const int kq = min(K, a.k - kdone);\n",
     "      const int kq = min(K, a.k - kdone);\n      const int jr = (kq + C - 1) / C;\n"),
    ("        const int tile = ord[t];\n",
     "        const int tile = ord[t];\n        float pk[R], pj[R];\n#pragma unroll\n"
     "        for (int r = 0; r < R; ++r) {\n"
     "          const bool rd = C > 1 && need[r] && lane < C && lane != rank;\n"
     "          pk[r] = rd ? peer_best(kpub + row_off + r, lane) : inf();\n"
     "          pj[r] = rd ? peer_best(jpub + row_off + r, lane) : 0.f;\n        }\n"),
    ("        bool want = false;\n        const float nl = t + C < NT ? lb[t + C] : inf();\n",
     "        float kd[R], jd[R];\n#pragma unroll\n        for (int r = 0; r < R; ++r) {\n"
     "          kd[r] = kth_dist(sel[r].kth);\n"
     "          jd[r] = C > 1 ? kth_dist(__shfl_sync(kFull, ws::pick(sel[r].w, (jr - 1) >> 5), (jr - 1) & 31)) : kd[r];\n"
     "        }\n        if (C > 1 && lane == 0) {\n#pragma unroll\n          for (int r = 0; r < R; ++r) {\n"
     "            if (need[r]) {\n"
     "              *reinterpret_cast<volatile float*>(kpub + row_off + r) = kd[r];\n"
     "              *reinterpret_cast<volatile float*>(jpub + row_off + r) = jd[r];\n            }\n          }\n"
     "        }\n        bool want = false;\n        const float nl = t + C < NT ? lb[t + C] : inf();\n"),
    ("          for (int r = 0; r < R; ++r) want |= need[r] && nl <= kth_dist(sel[r].kth);\n",
     "          for (int r = 0; r < R; ++r) {\n"
     "            const float b = C > 1 ? fminf(fminf(kd[r], gw::warp_min_nonneg(pk[r])), "
     "fmaxf(jd[r], warp_max_nonneg(pj[r]))) : kd[r];\n"
     "            want |= need[r] && nl <= b;\n          }\n"),
    ("        cluster.sync();  // the broadcast written, every peer's lists read\n",
     "        if (lane == 0) {\n          for (int r = 0; r < R; ++r) kpub[row_off + r] = jpub[row_off + r] = inf();\n"
     "        }\n        cluster.sync();  // the broadcast written, every peer's lists read\n"),
]
CD_VARIANTS = {
    "shipped: 4 stages, stop on the cluster's bound, register lists of 12 and 16": [],
    "1 stage": [(_STAGES, _STAGES.replace("4", "1"))],
    "2 stages": [(_STAGES, _STAGES.replace("4", "2"))],
    "8 stages": [(_STAGES, _STAGES.replace("4", "8"))],
    # the register route: each CTA stops on its own k-th (its peers' published values never read)
    "stop on each CTA's own k-th": [(_CD_SHARED, ""), (_CD_READS, _CD_READS.replace("C > 1", "false"))],
    # the register route: the stop on the cluster's least k-th alone, without the largest j-th
    "stop on the cluster's k-th alone": [("const float cb = fminf(fminf(kd, pk), fmaxf(jd, pj));",
                                          "const float cb = fminf(kd, pk);")],
    # the warp-select route's split walks: the stop on the cluster's bound (each CTA's own k-th shipped)
    "warp-select stop on the cluster's bound": _WS_PEER_STOP,
    # the warp-select route's walk split over up to 8 CTAs (2 shipped)
    "warp-select walk split up to 8 ways": [("constexpr int kWsSplit = 2;", "constexpr int kWsSplit = 8;")],
    # the register list's slots at k = 10: 16 (the larger list's) or 32 (the cap's limit) instead of 12
    "register list of 16": [("return k <= kRegSmall ?", "return k <= 0 ?")],
    "register list of 32": [("return k <= kRegSmall ?", "return k <= 0 ?"),
                            ("constexpr int kRegK = 16;", "constexpr int kRegK = 32;")],
    # the register cap at 0: every k on the warp-select route
    "warp-select route at every k": [("  if (k <= kRegK) return", "  if (k <= 0) return")],
    # the shipped bits, with each thread's kept columns and list inserts summed into visits[2], visits[3]
    "probe: kept columns and inserts": [
        ("  int visited = 0;\n  bool want = hdr_t[0] >= 0;\n",
         "  int visited = 0;\n  bool want = hdr_t[0] >= 0;\n  unsigned long long n_kept = 0, n_ins = 0;\n"),
        ("      if (keep != 0) {  // past a walk's first tiles, seldom\n",
         "      if (keep != 0) {  // past a walk's first tiles, seldom\n        n_kept += __popc(keep);\n"),
        ("          if (sq <= cap) {\n", "          if (sq <= cap) {\n            ++n_ins;\n"),
        (_DRAIN, "  if (a.visits != nullptr) {\n    atomicAdd(a.visits + 2, n_kept);\n    atomicAdd(a.visits + 3, n_ins);\n  }\n"
                 + _DRAIN)],
    # the shipped bits, with each warp's SM clocks summed by phase of the walk
    "probe: phase clocks": _A_CLOCKS,
}
CD_PHASES = ("wait and barrier", "copies and the header", "FMAs", "candidates, the list and the vote")
# the path's; the register route's 16-slot list (13, 16) against the warp-select route there; the warp-select route's
# queues of 32, 64, 128, 1024 (two rounds)
CD_MIN_PTS = (10, 13, 16, 17, 64, 100, 2000)
CD_EDGE = (13, 16)  # where the register route's 16-slot list runs: timed against the warp-select route alone
# per kernel: the source, its variants, its C entry and the mangled name of its d <= 16 instantiation
KINDS = {
    "round": ("grid_round.cu", VARIANTS, "repro_grid_round_tiles_f32", "grid_round_tiles_kernelILi16E"),
    "assign": ("grid_assign.cu", ASSIGN_VARIANTS, "repro_grid_assign_tiles_f32", "grid_assign_tiles_kernelILi16E"),
    "cd": ("grid_cd.cu", CD_VARIANTS, "repro_grid_cd_tiles_f32", "grid_cd_reg_kernelILi16ELi12E"),
}


def _apply(name: str, text: str, changes) -> str:
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} is in the source {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def _ptxas(log: str, kernel: str = KINDS["round"][3]) -> str:
    """Registers, stack and spills of the d <= 16 instantiation."""
    m = re.search(kernel + r".*?\n.*?(\d+) bytes stack frame, (\d+) bytes spill stores.*?\n"
                  r".*?Used (\d+) registers", log)
    return f"{m.group(3)} registers, {m.group(1)} bytes stack, {m.group(2)} bytes spilled" if m else "?"


def build(kind: str = "round") -> list[dict]:
    """One library per variant of ``kind`` (``KINDS``), built in parallel:
    [{name, lib, ptxas}]."""
    source, variants, entry, kernel = KINDS[kind]
    src = (_build._CSRC / source).read_text()
    out = _build._BUILD / "grid_variants" / kind
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, changes) in enumerate(variants.items()):
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
        getattr(lib, entry).argtypes = getattr(main, entry).argtypes
        libs.append(dict(name=name, lib=lib, ptxas=_ptxas(log, kernel)))
    return libs


def stream_points():
    """The [grid] stream's points and its held-out queries (chip_smoke.py's
    [stream] data, drawn together)."""
    rng = np.random.default_rng(SEED)
    n = N_POINTS + N_QUERIES
    centres = rng.normal(scale=3.0, size=(20, DIM))
    data = centres[rng.integers(0, 20, size=n)] + rng.normal(size=(n, DIM)) + 50.0
    return data[:N_POINTS], data[N_POINTS:]


def stream_table(dev, X=None):
    """The [grid] stream's table after its full flush: the engine's
    representatives, extents and masses (chip_smoke.py's [stream] data)."""
    from .. import StreamingClusterEngine

    X = stream_points()[0] if X is None else X
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = argv or list(KINDS)
    if any(k not in KINDS for k in kinds):
        print(f"grid_variants: kinds are {sorted(KINDS)}, got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("grid_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    X, Qs = stream_points()
    table = stream_table(dev, X)
    code = 0
    for kind in kinds:
        if kind == "round":
            code = code or round_variants(dev, table)
        elif kind == "assign":
            code = code or assign_variants(dev, table, X, Qs)
        else:
            code = code or cd_variants(dev, table)
    return code


def round_variants(dev, table) -> int:
    """The round kernel's variants in every working round of one pass and one
    empty round."""
    libs = build("round")
    for v in libs:
        print(f"library {v['name']!r}: {v['ptxas']}")
    grid, views, cd, rounds = pass_rounds(dev, table)
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



def assign_variants(dev, table, X, Qs) -> int:
    """The assign kernel's variants at the ingest and query shapes on the
    stream's table."""
    libs = build("assign")
    for v in libs:
        print(f"assign library {v['name']!r}: {v['ptxas']}")
    rep = table[0]
    L, d = rep.shape
    mu = rep.mean(axis=0)
    r = torch.as_tensor((rep - mu).astype(np.float32), device=dev)
    Lp = 1 << (L - 1).bit_length()
    grid = _grid.build_grid(torch.cat([r, r.new_full((Lp - L, d), 1e6)]), torch.arange(Lp, device=dev) < L)
    NT = grid.tile_lo.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    # the kernels alone, as grid.py launches them: the first kernel, and the shipped one at each cluster size
    kernels = {"v1": ("grid_assign_v1", "repro_grid_assign_f32", ())}
    kernels.update({c: ("grid_assign", "repro_grid_assign_tiles_f32", (c,)) for c in CLUSTERS})
    bad = []
    for shape, pts in (("ingest", X[:BLOCK]), ("query", Qs[:QUERY_SHAPE])):
        q = torch.as_tensor((pts - mu).astype(np.float32), device=dev)
        xs, _, views = _grid._query_views(grid, q)
        B = xs.shape[0]
        want = _grid._assign_sorted(*kernels["v1"], grid, xs, views)
        outs, calls, counts = {}, {}, {}
        for v in libs:
            idx = torch.empty(B, dtype=torch.int32, device=dev)
            dist = torch.empty(B, device=dev)
            outs[v["name"]] = (idx, dist)

            def call(lib=v["lib"], idx=idx, dist=dist, visits=None):
                _build.check(lib.repro_grid_assign_tiles_f32(
                    xs.data_ptr(), B, *_grid._grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), NT,
                    _grid.ASSIGN_CLUSTER, idx.data_ptr(), dist.data_ptr(), visits, stream), "grid assign variant")

            calls[v["name"]] = call
            counters = torch.zeros(2 + len(ASSIGN_PHASES), dtype=torch.int64, device=dev)
            call(visits=counters.data_ptr())
            counts[v["name"]] = counters.cpu().numpy()
            if v is libs[0]:
                for c in CLUSTERS:
                    calls[f"shipped at cluster {c}"] = lambda c=c: _grid._assign_sorted(*kernels[c], grid, xs, views)
        same = {name: bool(torch.equal(i, want[0]) and torch.equal(t, want[1])) for name, (i, t) in outs.items()}
        walks = {}
        for c in kernels:
            _grid.track_visits(True, dev)
            try:
                got = _grid._assign_sorted(*kernels[c], grid, xs, views)
                vc = _grid.visit_counts()
            finally:
                _grid.track_visits(False)
            walks[c] = (vc["grid_assign"], vc["grid_assign_longest"])
            if c != "v1":
                same[f"shipped at cluster {c}"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        calls["first kernel (csrc/grid.cu)"] = lambda: _grid._assign_sorted(*kernels["v1"], grid, xs, views)
        times = _turns(calls)
        v1v, v1w = walks["v1"]
        print(f"assign, {shape} shape: {B} queries x L = {L} reps (Lp = {Lp}, d = {d}), {views.order.shape[0]} "
              f"blocks x {NT} tiles; first kernel: {v1v} row-tile visits ({v1v / (B * NT):.4f} of rows x tiles), "
              f"longest walk of a CTA {v1w}; the shipped kernel (visits, extra, longest walk) by cluster: "
              + ", ".join(f"{c}: {walks[c][0]}, +{walks[c][0] - v1v}, {walks[c][1]}" for c in CLUSTERS)
              + f"; libraries at cluster {_grid.ASSIGN_CLUSTER}:")
        for name, t in times.items():
            extra = ""
            if name in counts:
                extra = f"; visits {int(counts[name][0])}, longest walk {int(counts[name][1])}"
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in t)} ms"
                  + (f"; bit for bit the first kernel: {same[name]}" if name in same else "") + extra)
        split = counts["probe: phase clocks"][2:].astype(np.float64)
        if split.sum() > 0:
            print("  the walk's SM clocks by phase, all warps: "
                  + ", ".join(f"{p} {c / split.sum():.3f}" for p, c in zip(ASSIGN_PHASES, split)))
        bad += [f"{shape}: {n}" for n, ok in same.items() if not ok]
    if bad:
        print(f"grid_variants: assign variants not bit for bit the first kernel: {bad}", file=sys.stderr)
        return 1
    return 0


def cd_variants(dev, table) -> int:
    """The Eq. 6 kernel's variants on the stream's table as the offline pass
    pads it, at each of ``CD_MIN_PTS``."""
    from . import ops

    libs = build("cd")
    for v in libs:
        print(f"cd library {v['name']!r}: {v['ptxas']}")
    rep, extent, n_b, _ = table
    L, d = rep.shape
    (rep_t, nb_t, ext_t), _, _ = ops._prepare_table(rep, n_b, extent, MIN_PTS, dev)
    grid, views = ops._grid_table(rep_t, L)
    Lp = rep_t.shape[0]
    NB, NT = views.order.shape
    stream = torch.cuda.current_stream().cuda_stream
    bad = []
    for m in CD_MIN_PTS:
        mp = ops._clamp_min_pts(m, float(n_b.sum()))
        args = (grid, nb_t, ext_t, mp, d, views, (0, NB))
        want = _grid.grid_core_distances_v1(*args)
        if m == MIN_PTS:
            chosen = libs
        elif m in CD_EDGE:
            chosen = [v for v in libs if v is libs[0] or v["name"] == "warp-select route at every k"]
        else:
            chosen = [v for v in libs if v is libs[0] or v["name"].startswith("warp-select") and "every k" not in v["name"]]
        outs, calls, counts = {}, {}, {}
        for v in chosen:
            out = torch.empty(NB * 64, device=dev)
            outs[v["name"]] = out

            def call(lib=v["lib"], out=out, visits=None):
                _build.check(lib.repro_grid_cd_tiles_f32(
                    *_grid._grid_args(grid), views.order.data_ptr(), views.lbs.data_ptr(), NT, nb_t.data_ptr(),
                    ext_t.data_ptr(), min(mp, Lp), mp, d, 0, NB, _grid.CD_CLUSTER, out.data_ptr(), visits, stream),
                    "grid Eq. 6 variant")

            calls[v["name"]] = call
            counters = torch.zeros(2 + len(CD_PHASES), dtype=torch.int64, device=dev)
            call(visits=counters.data_ptr())
            counts[v["name"]] = counters.cpu().numpy()
            if v is libs[0]:
                for c in CLUSTERS:
                    calls[f"shipped at cluster {c}"] = lambda c=c: _grid.grid_core_distances(*args, cluster=c)
        same = {name: bool(torch.equal(out, want)) for name, out in outs.items()}
        walks = {}
        for c in ("v1",) + CLUSTERS:
            _grid.track_visits(True, dev)
            try:
                got = (_grid.grid_core_distances_v1(*args) if c == "v1"
                       else _grid.grid_core_distances(*args, cluster=c))
                vc = _grid.visit_counts()
            finally:
                _grid.track_visits(False)
            walks[c] = (vc["grid_core_distances"], vc["grid_core_longest"])
            if c != "v1":
                same[f"shipped at cluster {c}"] = bool(torch.equal(got, want))
        calls["first kernel (csrc/grid.cu)"] = lambda: _grid.grid_core_distances_v1(*args)
        times = _turns(calls)
        v1v, v1w = walks["v1"]
        print(f"Eq. 6 at min_pts {mp} (k = {min(mp, Lp)}): L = {L}, Lp = {Lp}, d = {d}, {NB} blocks x {NT} tiles; "
              f"first kernel: {v1v} row-tile visits ({v1v / (Lp * NT):.4f} of rows x tiles), longest walk of a CTA "
              f"{v1w}; the shipped kernel (visits, against v1's, longest walk) by cluster: "
              + ", ".join(f"{c}: {walks[c][0]}, {walks[c][0] - v1v:+d}, {walks[c][1]}" for c in CLUSTERS)
              + f"; libraries at cluster {_grid.CD_CLUSTER}:")
        for name, t in times.items():
            extra = ""
            if name in counts:
                extra = f"; visits {int(counts[name][0])}, longest walk {int(counts[name][1])}"
            print(f"  {name}: {' / '.join(f'{x:.4f}' for x in t)} ms"
                  + (f"; bit for bit the first kernel: {same[name]}" if name in same else "") + extra)
        if "probe: kept columns and inserts" in counts:
            kept, ins = counts["probe: kept columns and inserts"][2:4]
            print(f"  kept columns {int(kept)}, list inserts {int(ins)} over the rows' walks")
        if "probe: phase clocks" in counts:
            split = counts["probe: phase clocks"][2:].astype(np.float64)
            if split.sum() > 0:
                print("  the walk's SM clocks by phase, all warps: "
                      + ", ".join(f"{p} {c / split.sum():.3f}" for p, c in zip(CD_PHASES, split)))
        bad += [f"min_pts {mp}: {n}" for n, ok in same.items() if not ok]
    if bad:
        print(f"grid_variants: Eq. 6 variants not bit for bit the first kernel: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
