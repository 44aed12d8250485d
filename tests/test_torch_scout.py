"""Algorithm-1 scout of the PyTorch port against the JAX reference.

Decision by decision: the port's plain ``scout_step_ref`` (the version the
CUDA ``scout_step`` kernel is held to on the card) against
``repro.kernels.ref.scout_step_ref`` on seeded random batches — random
positions, entry ports, full 32-bit rng patterns and busy/tried maps — on
the 2x2 and 8x8 meshes with both ``allow_nonminimal`` values.  Walk by
walk: the port's vectorised DFS (``scout_walk_ref``, the walk inside the
lane scan) against the scalar oracle ``repro.core.routing.scout_route_ref``.
All comparisons are exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.rng import xorshift32_py
from repro.core.routing import scout_route_ref as j_route_ref
from repro.core.topology import build_mesh
from repro.kernels.ref import scout_step_ref as j_step_ref

from port_parity import jax_reference, torch_threads
from repro_torch.core.routing import scout_route_ref as p_route_ref
from repro_torch.kernels import ref as kref
from repro_torch.kernels.scout import scout_step

MESHES = [(2, 2), (8, 8)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def _batch(topo, B, seed):
    rs = np.random.RandomState(seed)
    state = np.zeros((B, 8), np.int32)
    state[:, 0] = rs.randint(0, topo.n_nodes, B)
    state[:, 1] = rs.randint(0, topo.n_nodes, B)
    state[:, 2] = rs.randint(-1, 4, B)
    state[:, 3] = rs.randint(-2**31, 2**31 - 1, B, dtype=np.int64)
    density = rs.rand(B, 1)
    busy = np.zeros((B, 128), np.int32)
    busy[:, :topo.n_links] = rs.rand(B, topo.n_links) < density
    tried = (rs.rand(B, 4 * topo.n_nodes) < density / 2).astype(np.int32)
    return state, busy, tried


@pytest.mark.parametrize("rows,cols", MESHES)
@pytest.mark.parametrize("allow", [True, False])
def test_scout_step_matches_jax_ref(rows, cols, allow):
    topo = build_mesh(rows, cols)
    state, busy, tried = _batch(topo, 2048, rows * 100 + cols * 10 + int(allow))
    got = scout_step(torch.from_numpy(state), torch.from_numpy(busy),
                     torch.from_numpy(tried), torch.from_numpy(topo.port_link),
                     torch.from_numpy(topo.port_neighbor), cols, allow)
    with jax_reference():
        want = j_step_ref(jnp.asarray(state), jnp.asarray(busy), jnp.asarray(tried),
                          jnp.asarray(topo.port_link), jnp.asarray(topo.port_neighbor),
                          cols, allow)
        want = [np.asarray(w) for w in want]
    for g, w, name in zip(got, want, ("state", "busy", "tried")):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w), name
    # every decision kind occurs in the batch
    assert set(np.unique(want[0][:, 4])) == {0, 1, 2}


def test_rng_stream_matches_scalar():
    rs = np.random.RandomState(7)
    xs = rs.randint(0, 2**32, 4096, dtype=np.int64)
    got = kref.xorshift32(torch.from_numpy(xs)).numpy()
    assert [int(v) for v in got] == [xorshift32_py(int(v)) for v in xs]
    lcg = kref.lcg_advance(torch.from_numpy(xs)).numpy()
    assert [int(v) for v in lcg] == [((int(v) * 747796405 + 2891336453) & 0xFFFFFFFF) | 1
                                     for v in xs]


@pytest.mark.parametrize("rows,cols", MESHES)
@pytest.mark.parametrize("allow", [True, False])
def test_walks_match_scout_route_ref(rows, cols, allow):
    topo = build_mesh(rows, cols)
    rs = np.random.RandomState(rows * 7 + cols + 31 * int(allow))
    B = 256
    src = rs.randint(0, topo.n_nodes, B)
    dst = rs.randint(0, topo.n_nodes, B)
    seeds = rs.randint(1, 2**32, B, dtype=np.int64)
    busy = rs.rand(B, topo.n_links) < rs.rand(B, 1) * 0.7
    mesh = kref.MeshTables(torch.from_numpy(topo.port_link),
                           torch.from_numpy(topo.port_neighbor), cols, 2)
    walk = kref.scout_walk_ref(
        mesh, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(busy),
        torch.from_numpy(seeds), torch.full((B,), allow), torch.ones(B, dtype=torch.bool))
    outcomes = set()
    for b in range(B):
        want = j_route_ref(topo, int(src[b]), int(dst[b]), busy[b], int(seeds[b]), allow)
        mine = p_route_ref(topo, int(src[b]), int(dst[b]), busy[b], int(seeds[b]), allow)
        assert (mine.success, mine.hops, mine.steps, mine.misroutes) == \
            (want.success, want.hops, want.steps, want.misroutes)
        assert bool(walk.success[b]) == want.success
        assert int(walk.hops[b]) == want.hops
        assert int(walk.steps[b]) == want.steps
        assert int(walk.misroutes[b]) == want.misroutes
        path = np.zeros(topo.n_links, bool)
        path[want.path_links] = True
        assert np.array_equal(walk.path_mask[b].numpy(), path)
        outcomes.add((want.success, want.misroutes > 0))
    assert (True, False) in outcomes and (False, False) in outcomes
    if allow and rows > 2:
        assert (True, True) in outcomes  # misroutes really happen
