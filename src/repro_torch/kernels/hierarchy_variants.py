"""Time variants of the single-linkage kernel side by side on one card.

    PYTHONPATH=src python -m repro_torch.kernels.hierarchy_variants    # one NVIDIA GPU

Each variant is ``csrc/hierarchy_par.cu`` with its walk (the one thread
that runs a chunk's merges over the slots) replaced, built by ``nvcc``
into a library of its own under ``build/`` and called through the same C
entry as the shipped kernel.  Walks written over two slot arrays
(``la``, ``lb``) read the kernel's one array of slot pairs.  The
variants: the shipped walk with a skipped merge on selects of its two
records or on a branch (not as a flag in the merge record with its slot
record stored to a spare slot), then also not unrolled, or with a loop
branch per end instead of one slow-path branch; "two loads a step"
reads the ends' parents after the step before has stored, then their
records; "walk without look-ahead" also finds each end's root after the
other's, with if/else stores; "probe: no walk" skips the walk and gives
wrong outputs: it shows what the parallel phases and the launch cost,
nothing else.  Beside them, the first version's kernel
(``csrc/hierarchy.cu``) through the port's library.  All are timed in
turns (a, b, ..., b, a: CUDA events around 10 calls each) on three sets
of sorted edge buffers: the offline pass's own Borůvka buffers over
5,243 unit bubbles of a seeded 20-blob mixture at d = 16 (Lp = 8192, as
the stream's full table), and chains (a dendrogram Lp − 1 deep) at
Lp = 8192 and 32,768; with ptxas's registers of each variant's kernel.
Nothing in the port calls this module.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from ..core import hierarchy as th
from . import _build, hierarchy, ops

_WALK_START = "    if (tid == 0) {  // the walk: the chunk's merges in edge order over the slots\n"
_WALK_END = "    __syncthreads();\n\n    if (mine) {  // the merge records out"
_PLAIN_WALK = _WALK_START + """      for (int t = 0; t < cnt; ++t) {
        int a = la[t], b = lb[t];
        const int a0 = a, b0 = b;
        int4 A = rec[a], B = rec[b];
        while (A.x != a) {
          a = A.x;
          A = rec[a];
        }
        while (B.x != b) {
          b = B.x;
          B = rec[b];
        }
        const float wsum = __fadd_rn(__int_as_float(A.z), __int_as_float(B.z));
        if (a != b) {
          const int root = A.w >= B.w ? a : b;
          out[t] = make_int4(A.y, B.y, __float_as_int(wsum), 0);
          rec[a + b - root].x = root;
          rec[a0].x = root;
          rec[b0].x = root;
          rec[root] = make_int4(root, Lp + k0 + t, __float_as_int(wsum), A.w + B.w);
        } else {
          out[t] = make_int4(trash, trash, 0, 0);
          trash_w = wsum;
          skipped = true;
        }
      }
    }
"""
_TWO_LOADS = _WALK_START + """      for (int t = 0; t < cnt; ++t) {
        const int a0 = la[t], b0 = lb[t];
        int a = rec[a0].x, b = rec[b0].x;
        int4 A = rec[a], B = rec[b];
        while (A.x != a) {
          a = A.x;
          A = rec[a];
        }
        while (B.x != b) {
          b = B.x;
          B = rec[b];
        }
        const float wsum = __fadd_rn(__int_as_float(A.z), __int_as_float(B.z));
        const bool linked = a != b;
        const int root = A.w >= B.w ? a : b;
        const int other = a + b - root;
        out[t] = linked ? make_int4(A.y, B.y, __float_as_int(wsum), 0) : make_int4(trash, trash, 0, 0);
        rec[other].x = root;
        rec[a0].x = root;
        rec[b0].x = root;
        rec[root] = linked ? make_int4(root, Lp + k0 + t, __float_as_int(wsum), A.w + B.w) : A;
        trash_w = linked ? trash_w : wsum;
        skipped = skipped || !linked;
      }
    }
"""


_BRANCH = """        rec[other].x = root;
        rec[a0].x = root;
        rec[b0].x = root;
        if (a != b) {
          out[t] = make_int4(A.y, B.y, __float_as_int(wsum), 0);
          rec[root] = make_int4(root, Lp + k0 + t, __float_as_int(wsum), A.w + B.w);
        } else {
          out[t] = make_int4(trash, trash, 0, 0);
          trash_w = wsum;
          skipped = true;
        }
"""
_SELECTS = """        const bool linked = a != b;
        out[t] = linked ? make_int4(A.y, B.y, __float_as_int(wsum), 0) : make_int4(trash, trash, 0, 0);
        rec[other].x = root;
        rec[a0].x = root;
        rec[b0].x = root;
        rec[root] = linked ? make_int4(root, Lp + k0 + t, __float_as_int(wsum), A.w + B.w) : A;
        trash_w = linked ? trash_w : wsum;
        skipped = skipped || !linked;
"""


def _lean(unroll: int, one_branch: bool, selects: bool = False) -> str:
    """The walk with a skipped merge on a branch (``selects``: on selects
    of its two records), unrolled ``unroll`` times (0: as the compiler
    likes), the two root loops behind one branch when ``one_branch``."""
    loops = """        while (A.x != a) {
          a = A.x;
          A = rec[a];
        }
        while (B.x != b) {
          b = B.x;
          B = rec[b];
        }
"""
    if one_branch:
        loops = "        if (A.x != a || B.x != b) {\n" + "".join("  " + ln + "\n" for ln in loops.splitlines()) + "        }\n"
    return _WALK_START + """      int a0 = la[0], b0 = lb[0], a1 = la[1], b1 = lb[1];
      int pa = rec[a0].x, pb = rec[b0].x;
      int e0 = -1, e1 = -1, e2 = -1, er = 0;
""" + (f"#pragma unroll {unroll}\n" if unroll else "") + """      for (int t = 0; t < cnt; ++t) {
        const int a2 = la[t + 2], b2 = lb[t + 2];
        const int na = rec[a1].x, nb = rec[b1].x;
        int a = (a0 == e0 || a0 == e1 || a0 == e2) ? er : pa;
        int b = (b0 == e0 || b0 == e1 || b0 == e2) ? er : pb;
        int4 A = rec[a], B = rec[b];
""" + loops + """        const float wsum = __fadd_rn(__int_as_float(A.z), __int_as_float(B.z));
        const int root = A.w >= B.w ? a : b;
        const int other = a + b - root;
""" + (_SELECTS if selects else _BRANCH) + """        e0 = a0;
        e1 = b0;
        e2 = other;
        er = root;
        a0 = a1;
        b0 = b1;
        a1 = a2;
        b1 = b2;
        pa = na;
        pb = nb;
      }
    }
"""


# name -> the walk's replacement (None: the shipped walk)
VARIANTS = {"shipped (parents a step ahead, one slow-path branch, unrolled 4, skips as flags)": None,
            "skips on selects": _lean(4, True, True),
            "skips on selects, not unrolled": _lean(0, True, True),
            "skips on a branch": _lean(4, True),
            "skips on selects, a loop branch per end, not unrolled": _lean(0, False, True),
            "two loads a step": _TWO_LOADS, "walk without look-ahead": _PLAIN_WALK, "probe: no walk": ""}


def _on_ends(walk: str) -> str:
    """A walk written over the slot arrays ``la[i]`` / ``lb[i]`` read from
    the kernel's ``ends[i].x`` / ``.y``."""
    return re.sub(r"\bl([ab])\[([^\]]+)\]", lambda m: f"ends[{m.group(2)}].{'x' if m.group(1) == 'a' else 'y'}", walk)


def build() -> dict[str, tuple[ctypes.CDLL, str]]:
    """{variant: (library, ptxas registers of its shared-memory kernel)}, built in parallel."""
    src = (_build._CSRC / "hierarchy_par.cu").read_text()
    i0, i1 = src.index(_WALK_START), src.index(_WALK_END)
    out = _build._BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, walk) in enumerate(VARIANTS.items()):
        cu = out / f"hier{i}.cu"
        cu.write_text(src if walk is None else src[:i0] + _on_ends(walk) + src[i1:])
        cmd = [_build._nvcc(), *_build._ARCH, *_build._FLAGS, "-shared", "-I", str(_build._CSRC), str(cu),
               "-o", str(out / f"hier{i}.so")]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, p) in procs.items():
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log[-4000:]}")
        m = re.search(r"single_linkage_par_kernelILb1E.*?\n.*?\n.*?Used (\d+) registers", log)
        lib = ctypes.CDLL(str(out / f"hier{i}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_single_linkage_par_f32.argtypes = [P, P, P, P, I, I, P, P, P, P, P, P, P]
        libs[name] = (lib, f"{m.group(1)} registers" if m else "?")
    return libs


def cases(dev) -> dict:
    """{name: (u_s, v_s, w_s, weights)} on ``dev``."""
    rng = np.random.default_rng(20241209)
    centres = rng.normal(scale=3.0, size=(20, 16))
    X = centres[rng.integers(0, 20, size=5243)] + rng.normal(size=(5243, 16))
    (rep, nb, ext), min_pts, _ = ops._prepare_table(X - X.mean(0), np.ones(5243), np.zeros(5243), 10, dev)
    out = ops._offline_pipeline(rep, nb, ext, 5243, 10.0, min_pts)
    found = {"mixture Lp=8192": (th.sorted_edges(out["eu"], out["ev"], out["ew"], out["valid"], 5243), nb)}
    for Lp in (8192, 32768):
        perm, n_e = rng.permutation(Lp), Lp - 1
        u, v = torch.as_tensor(perm[1:], device=dev), torch.as_tensor(perm[:-1], device=dev)
        w = torch.as_tensor(1.0 + np.sort(rng.choice(1 << 20, n_e, replace=False)) / 1024.0, device=dev).float()
        pad = torch.zeros(1, dtype=torch.long, device=dev)
        valid = torch.arange(Lp, device=dev) < n_e
        edges = th.sorted_edges(torch.cat([u, pad]), torch.cat([v, pad]), torch.cat([w, pad.float()]), valid, Lp)
        found[f"chain Lp={Lp}"] = (edges, torch.as_tensor(rng.integers(1, 6, Lp), device=dev).float())
    return {name: (*(t.to(torch.int32 if t.dtype == torch.long else torch.float32).contiguous() for t in e),
                   nb.float().contiguous()) for name, (e, nb) in found.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("hierarchy_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build()
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; single-linkage kernels, ms per call (in turns)")
    for case, (u_s, v_s, w_s, weights) in cases(dev).items():
        Lp = u_s.shape[0]
        smem, nbytes = hierarchy.plan("single_linkage", Lp)
        scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
        outs = {}

        def call(lib, key):
            o = outs.setdefault(key, [torch.empty(n, dtype=dt, device=dev) for n, dt in (
                (Lp - 1, torch.int32), (Lp - 1, torch.int32), (Lp - 1, torch.float32), (Lp - 1, torch.float32),
                (2 * Lp, torch.float32))])
            code = lib.repro_single_linkage_par_f32(u_s.data_ptr(), v_s.data_ptr(), w_s.data_ptr(),
                                                    weights.data_ptr(), Lp, int(smem), scratch.data_ptr(),
                                                    *(t.data_ptr() for t in o), torch.cuda.current_stream().cuda_stream)
            _build.check(code, "single_linkage variant")

        runs = {name: (lambda lib=lib, name=name: call(lib, name)) for name, (lib, _) in libs.items()}
        runs["first version (csrc/hierarchy.cu)"] = lambda: hierarchy.single_linkage_sorted_v1(u_s, v_s, w_s, weights)

        def ms(fn, reps=10):
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

        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(ms(runs[name]))
        want = hierarchy.single_linkage_sorted_v1(u_s, v_s, w_s, weights)
        print(f"  {case} (state in {'shared memory' if smem else 'scratch'}):")
        for name, t in times.items():
            same = ("wrong by design" if name.startswith("probe") else "the first version's bits" if name not in outs
                    or all(torch.equal(g, w) for g, w in zip(outs[name], want)) else "DIFFERS from the first version")
            regs = libs[name][1] if name in libs else "the port's library"
            print(f"    {name}: {' / '.join(f'{x:.4f}' for x in t)} ms; {regs}; {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
