"""The CPU models of the redesigned hierarchy kernels, on the CPU.

``core/hierarchy.py``'s ``single_linkage_chunked`` and ``condense_jump``
run the algorithms of ``csrc/hierarchy_par.cu`` in numpy: single-linkage
by chunks (the ends' roots at the chunk's start, one walk over a small
union-find of those roots), condense with no sequential walk (pointer
jumping over chunks of merges from the top id down, labels by a suffix
count).  Both must give every field of the plain loops
(``single_linkage_fixed``, ``condense_fixed``) and of the JAX package's
``repro.core.hierarchy_jax.single_linkage_fixed`` / ``condense_fixed``
bit for bit, dtypes included: every value is a copy, a comparison or the
loop's one f32 add.  The inputs are the seeded Borůvka-shaped buffers of
``tests/test_torch_hierarchy_cuda.py::edge_buffers``: the corners of
``tests/test_torch_offline.py``, deep dendrograms (a chain and a star of
depth Lp − 1, a comb of splits ~Lp / 6 deep), ``n_valid`` at the
kernel's 1024-merge chunk ± 1, the smallest buckets (Lp = 2, 3), each at
the kernel's chunk and at chunks of 4 and 8, so that many chunk borders
show.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy_jax as hj
from repro_torch.core import hierarchy as th
from test_torch_hierarchy_cuda import edge_buffers
from test_torch_offline import CORNERS

# (Lp, n_valid, edge_buffers options, min_cluster_size)
CASES = {
    **{f"corner {name}": case for name, case in CORNERS.items()},
    "chain": (512, 512, {"shape": "chain"}, 5.0),
    "star": (512, 512, {"shape": "star", "masses": "frac"}, 3.0),
    "comb": (512, 500, {"shape": "comb"}, 5.0),
    "comb fractional": (2048, 2000, {"shape": "comb", "masses": "frac"}, 8.0),
    "n_valid 1023": (2048, 1023, {}, 5.0),
    "n_valid 1024": (2048, 1024, {}, 5.0),
    "n_valid 1025": (2048, 1025, {"shape": "chain"}, 5.0),
    "Lp 2": (2, 2, {}, 1.0),
    "Lp 3": (3, 3, {"shape": "chain"}, 1.0),
}
CHUNKS = (4, 8, 1024)

_sl_jit = jax.jit(hj.single_linkage_fixed)
_cd_jit = jax.jit(hj.condense_fixed)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The case's buffers and (plain, JAX) single-linkage and condensed
    arrays, computed once per case."""
    Lp, nv, opts, mcs = CASES[name]
    bufs = edge_buffers(Lp, nv, 7, **opts)
    t = [torch.from_numpy(a) for a in bufs]
    p_slt = th.single_linkage_fixed(*t[:4], nv, t[4])
    p_ct = th.condense_fixed(p_slt, t[4], mcs)
    j_slt = _sl_jit(*(jnp.asarray(a) for a in bufs[:4]), nv, jnp.asarray(bufs[4]))
    j_ct = _cd_jit(j_slt, jnp.asarray(bufs[4]), mcs)
    return t, (p_slt, p_ct), (j_slt, j_ct)


def _assert_bitwise(got, want, what):
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and g.shape == w.shape, (what, field, g.dtype, w.dtype)
        assert np.array_equal(g.view(np.uint32) if g.dtype == np.float32 else g,
                              w.view(np.uint32) if w.dtype == np.float32 else w), (what, field)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(CASES))
def test_single_linkage_chunked(name, chunk):
    t, (p_slt, _), (j_slt, _) = _reference(name)
    Lp, nv, _, _ = CASES[name]
    got = th.single_linkage_chunked(*t[:4], nv, t[4], chunk=chunk)
    _assert_bitwise(got, p_slt, "plain loop")
    _assert_bitwise(got, j_slt, "JAX package")


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", list(CASES))
def test_condense_jump(name, chunk):
    t, (p_slt, p_ct), (_, j_ct) = _reference(name)
    got = th.condense_jump(p_slt, t[4], CASES[name][3], chunk=chunk)
    _assert_bitwise(got, p_ct, "plain loop")
    _assert_bitwise(got, j_ct, "JAX package")


def test_deep_cases_are_deep():
    """The chain and the star are dendrograms of depth Lp − 1, and the
    comb founds labels all the way down: what a cut-short jump or a walk
    that lost a merge would get wrong."""
    for name, labels_at_least in (("chain", 1), ("star", 1), ("comb", 150)):
        _, (p_slt, p_ct), _ = _reference(name)
        Lp = CASES[name][0]
        left, right = p_slt.left.numpy(), p_slt.right.numpy()
        parent = np.full(2 * Lp, -1)
        for i in range(Lp - 1):
            parent[[left[i], right[i]]] = Lp + i
        depth = np.zeros(2 * Lp, np.int64)
        for x in range(2 * Lp - 3, -1, -1):
            if parent[x] >= 0:
                depth[x] = depth[parent[x]] + 1
        if name != "comb":
            assert depth.max() == Lp - 1, name
        assert int(p_ct.n_labels) >= labels_at_least, name
