"""Which kernel route a CUDA call takes, decided on the CPU.

``repro_torch.kernels.knn.route`` and ``repro_torch.kernels.bubble_cd.route``
are pure functions of the feature width and k (min_pts): ``"ws"`` (the
warp-select kernels, d ≤ 128 and k ≤ 1024) or ``"strip"`` (row strips of
the pairwise panel kernel, a stable sort and, for Eq. 6, the walk kernel)
otherwise.  ``pairwise.strip_rows`` sizes the strips,
``assign.split_for`` the assign kernel's split of L across blocks (from
its occupancy, read from the card) and ``pairwise.panel_plan`` the
distance panel's persistent grid and its 16-byte stores.  The kernels run
only on a card (tests/test_torch_cuda.py); the rules are held here, and
so is the build's list of sources.  The hierarchy sweeps' wrappers
(``kernels/hierarchy.py``) take CPU tensors to the plain loops with no
launch counted and refuse any device but cpu and cuda; ``hierarchy.plan``
puts each sweep's state in shared memory where it fits one block.
"""

from pathlib import Path

import pytest
import torch

from repro_torch.core import hierarchy as t_plain
from repro_torch.kernels import _build
from repro_torch.kernels import assign as t_assign
from repro_torch.kernels import bubble_cd as t_bcd
from repro_torch.kernels import hierarchy as t_h
from repro_torch.kernels import knn as t_knn
from repro_torch.kernels import mutual_reach as t_mr
from repro_torch.kernels import pairwise as t_pw


@pytest.mark.parametrize("rule", [t_knn.route, t_bcd.route])
@pytest.mark.parametrize("d,k,want", [
    (1, 1, "ws"), (16, 10, "ws"), (128, 1024, "ws"), (5, 1024, "ws"),
    (129, 1, "strip"), (200, 10, "strip"), (16, 1025, "strip"), (128, 2000, "strip"), (300, 5000, "strip")])
def test_route(rule, d, k, want):
    assert rule(d, k) == want


def test_route_bounds_are_the_kernels():
    assert t_knn.MAX_DIM == t_bcd.MAX_DIM == 128
    assert t_knn.MAX_K == t_bcd.MAX_MIN_PTS == 1024


@pytest.mark.parametrize("m", [1, 3, 1000, 65_536, 1 << 26, 1 << 30])
def test_strip_rows(m):
    rows = t_pw.strip_rows(m)
    assert rows >= 1
    assert rows == 1 or rows * m * 4 <= t_pw.STRIP_BYTES < (rows + 1) * m * 4


@pytest.mark.parametrize("n,L", [(1, 1), (1, 8192), (4096, 5243), (4096, 8192), (8192, 8192), (65_536, 8192),
                                 (300, 255), (10, 100_000)])
@pytest.mark.parametrize("rows_per_block", [8, 32, 64])
@pytest.mark.parametrize("resident", [1, 132, 264])
def test_split_for(n, L, rows_per_block, resident):
    """The L split fills the blocks the card holds at once and no more:
    row blocks × slices never reach a second wave, and one slice more
    would (or the slices are down to MIN_SPAN reps)."""
    split = t_assign.split_for(n, L, rows_per_block, resident)
    blocks = -(-n // rows_per_block)
    assert split >= 1
    if blocks * 2 > resident or L < 2 * t_assign.MIN_SPAN:
        assert split == 1
    else:
        assert blocks * split <= resident
        assert L // split >= t_assign.MIN_SPAN
        assert blocks * (split + 1) > resident or split == L // t_assign.MIN_SPAN


@pytest.mark.parametrize("n,rows_per_block,want", [(8192, 64, 1), (4096, 64, 2), (2048, 64, 4), (1, 64, 32)])
def test_split_for_path_shapes(n, rows_per_block, want):
    """Ingest blocks (8192 rows) fill the H100's 132 SMs alone; a query
    chunk of 4096 rows takes two slices of the stream's 8192-row bucket."""
    assert t_assign.split_for(n, 8192, rows_per_block, 132) == want


@pytest.mark.parametrize("n,m", [(1, 1), (127, 129), (1001, 777), (5243, 5243), (8192, 8192), (16_384, 16_384),
                                 (1024, 65_536), (65_536, 300)])
@pytest.mark.parametrize("resident", [1, 132, 264])
def test_panel_plan_grid(n, m, resident):
    """One persistent block per 128 × 128 tile, at most the blocks the card
    holds at once; the norm scratch covers both sides padded to whole
    tiles."""
    grid, _, floats = t_pw.panel_plan(n, m, 0, resident)
    tiles = -(-n // t_pw.TILE) * -(-m // t_pw.TILE)
    assert grid == min(tiles, resident) >= 1
    assert floats == (-(-n // t_pw.TILE) + -(-m // t_pw.TILE)) * t_pw.TILE
    assert floats % 4 == 0 and -(-n // t_pw.TILE) * t_pw.TILE % 4 == 0  # 16-byte norm loads of both sides


@pytest.mark.parametrize("m,ptr,vec", [(777, 0, False), (1024, 0, True), (1023, 0, False), (1022, 0, False),
                                       (8192, 512, True), (8192, 4, False), (8192, 8, False), (1000, 4000, True),
                                       (999, 3996, False)])
def test_panel_plan_stores(m, ptr, vec):
    """16-byte row stores only where every output row starts 16-byte
    aligned: m % 4 == 0 and the output's address a multiple of 16."""
    assert t_pw.panel_plan(300, m, ptr, 264)[1] is vec


@pytest.mark.parametrize("n,m,want", [(8192, 8192, 264), (16_384, 16_384, 264), (5243, 5243, 264), (300, 300, 9),
                                      (1, 1, 1)])
def test_panel_plan_path_shapes(n, m, want):
    """At the main path's W (Lp = 8192) and the point-level 16,384², the
    grid is two resident blocks per SM on the H100's 132; small tables
    take one block per tile."""
    assert t_pw.panel_plan(n, m, 256, 264)[0] == want


@pytest.mark.parametrize("oracle", ["pairwise_tile", "mutual_reach_tile"])
def test_tile_oracles_take_cuda_tensors_only(oracle):
    """pairwise_tile and mutual_reach_tile, the card's bitwise oracles of
    the panel kernel, run the tile kernel or refuse: no plain version for
    CPU tensors, and no launch counted."""
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(9, 3, generator=g), torch.randn(7, 3, generator=g)
    cx, cy = torch.rand(9, generator=g), torch.rand(7, generator=g)
    t_pw.launches_tile = t_mr.launches_tile = 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if oracle == "pairwise_tile":
            t_pw.pairwise_tile(x, y)
        else:
            t_mr.mutual_reach_tile(x, y, cx, cy, n_valid=5)
    assert t_pw.launches_tile == t_mr.launches_tile == 0


@pytest.mark.parametrize("suffix,listed", [(".cu", _build._SOURCES), (".cuh", _build._HEADERS)])
def test_build_lists_every_source(suffix, listed):
    """The library is built from every ``.cu`` under ``csrc/`` (and its
    digest covers every header), so no kernel is left out of the build."""
    csrc = Path(_build.__file__).with_name("csrc")
    assert sorted(listed) == sorted(p.name for p in csrc.glob("*" + suffix))
    assert len(set(listed)) == len(listed)


def _hierarchy_inputs(device, Lp=16):
    g = torch.Generator().manual_seed(3)
    eu = torch.arange(1, Lp, dtype=torch.int32)
    ev = (torch.rand(Lp - 1, generator=g) * eu).to(torch.int32)
    pad = torch.zeros(1, dtype=torch.int32)
    eu, ev = torch.cat([eu, pad]), torch.cat([ev, pad])
    ew = torch.cat([torch.rand(Lp - 1, generator=g), torch.zeros(1)])
    valid = torch.arange(Lp) < Lp - 1
    w = torch.randint(1, 5, (Lp,), generator=g).float()
    return tuple(t.to(device) for t in (eu, ev, ew, valid, w))


@pytest.mark.parametrize("method,allow_single", [("eom", False), ("leaf", True)])
def test_hierarchy_cpu_takes_the_plain_loops(method, allow_single):
    """CPU tensors run core/hierarchy.py's loops through the kernel
    wrappers: the same arrays, and no kernel launch counted."""
    eu, ev, ew, valid, w = _hierarchy_inputs("cpu")
    t_h.launches_single_linkage = t_h.launches_condense = t_h.launches_extract = t_h.launches_eom = 0
    got = t_plain.hierarchy_fixed(eu, ev, ew, valid, 16, w, 3.0, method=method, allow_single_cluster=allow_single)
    slt = t_plain.single_linkage_fixed(eu, ev, ew, valid, 16, w)
    ct = t_plain.condense_fixed(slt, w, 3.0)
    want = (slt, ct, t_plain.extract_fixed(ct, method=method, allow_single_cluster=allow_single))
    for g_arr, w_arr in zip(got, want):
        for field in w_arr._fields:
            assert torch.equal(getattr(g_arr, field), getattr(w_arr, field)), field
    assert t_h.launches_single_linkage == t_h.launches_condense == t_h.launches_extract == t_h.launches_eom == 0


def _to_meta(arrays):
    return type(arrays)(*(a.to("meta") for a in arrays))


@pytest.mark.parametrize("stage", ["single_linkage", "condense", "extract"])
def test_hierarchy_refuses_other_devices(stage):
    """Tensors on a device that is neither cpu nor cuda raise; nothing
    falls back."""
    eu, ev, ew, valid, w = _hierarchy_inputs("cpu")
    slt = t_plain.single_linkage_fixed(eu, ev, ew, valid, 16, w)
    ct = t_plain.condense_fixed(slt, w, 3.0)
    with pytest.raises(ValueError, match="runs on cuda or cpu, not meta"):
        if stage == "single_linkage":
            t_h.single_linkage(*(t.to("meta") for t in (eu, ev, ew, valid)), 16, w.to("meta"))
        elif stage == "condense":
            t_h.condense(_to_meta(slt), w.to("meta"), 3.0)
        else:
            t_h.extract(_to_meta(ct))


def test_hierarchy_refuses_mixed_devices():
    eu, ev, ew, valid, w = _hierarchy_inputs("cpu")
    with pytest.raises(ValueError, match="different devices"):
        t_h.single_linkage(eu, ev, ew, valid, 16, w.to("meta"))


def test_hierarchy_extract_v1_takes_cuda_tensors_only():
    """The earlier composition is the extract kernel's oracle on the card;
    it has no CPU route."""
    eu, ev, ew, valid, w = _hierarchy_inputs("cpu")
    ct = t_plain.condense_fixed(t_plain.single_linkage_fixed(eu, ev, ew, valid, 16, w), w, 3.0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        t_h.extract_v1(ct)


def test_hierarchy_extract_checks_the_method_first():
    eu, ev, ew, valid, w = _hierarchy_inputs("cpu")
    ct = t_plain.condense_fixed(t_plain.single_linkage_fixed(eu, ev, ew, valid, 16, w), w, 3.0)
    with pytest.raises(ValueError, match="unknown extraction method"):
        t_h.extract(ct, method="max")


@pytest.mark.parametrize("Lp", [8, 64, 1024, 4096, 8192, 16384, 32768, 65536])
@pytest.mark.parametrize("kind", ["single_linkage", "condense", "eom", "single_linkage_v1", "condense_v1", "extract"])
def test_hierarchy_plan(kind, Lp):
    """A sweep's state goes to shared memory exactly when it and the
    kernel's other shared buffers fit one block's opt-in limit, else to a
    scratch buffer of the state's size.  csrc/hierarchy_par.cu:
    single-linkage keeps a parent and a node per leaf beside its chunk's
    slot and merge records, slot roots and slot pairs; condense five words
    and two flags per merge beside its chunk's four arrays and a count per
    warp.  csrc/hierarchy.cu: EOM a sum and a count per label slot, the
    first versions their walk's state beside a staging ring of two
    chunks.  csrc/hierarchy_extract.cu, at the largest label count (2·Lp +
    1 slots), each array rounded up to 16 bytes: six words and two flags
    per label, 32 sort cells per label and a term per leaf, beside 256
    bytes of block-scan partials."""
    C = t_h.CHUNK
    smem, scratch = t_h.plan(kind, Lp)
    r16, n = (lambda b: -(-b // 16) * 16), 2 * Lp + 1
    state = {"single_linkage": 8 * Lp, "condense": 22 * Lp, "eom": 8 * (2 * Lp + 1),
             "single_linkage_v1": 12 * Lp, "condense_v1": 9 * Lp,
             "extract": 6 * r16(4 * n) + r16(2 * n) + r16(128 * n) + r16(4 * Lp)}[kind]
    buffers = {"single_linkage": (3 * C + 1) * 16 + 2 * C * 4 + 2 * (C + 2) * 4, "condense": 4 * C * 4 + C // 32 * 4,
               "eom": 0, "single_linkage_v1": 24 * C, "condense_v1": 40 * C, "extract": 256}[kind]
    assert smem == (state + buffers <= t_h.SMEM_BYTES)
    assert scratch == (0 if smem else state) and scratch % 4 == 0


def test_hierarchy_plan_at_the_stream_bucket():
    """At the stream's Lp = 8192 all three sweeps keep their state in
    shared memory; single-linkage does up to Lp = 16384 (and so do both
    first versions)."""
    kinds = ("single_linkage", "condense", "eom")
    assert all(t_h.plan(kind, 8192)[0] for kind in kinds)
    assert [t_h.plan(kind, 16384)[0] for kind in kinds] == [True, False, False]
    assert not any(t_h.plan(kind, 32768)[0] for kind in kinds)
    assert all(t_h.plan(kind, 16384)[0] for kind in ("single_linkage_v1", "condense_v1"))
