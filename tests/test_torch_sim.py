"""The PyTorch port's simulator against the JAX reference, exactly.

On the tiny fixtures of ``tests/conftest.py`` (2x2 mesh, a saturating
``src2_1`` trace) every lane runs through both packages — the port's
``simulate_sweep(..., device="cpu")`` (the plain versions of both lane
kernels) and ``repro.ssd.simulate_sweep`` — and every ``SimResult`` field
must be equal: the int32 tick arrays, hops/tries/misroutes, the request
surface and the float64 energies.  The same lanes are also fed the
reference's own transactions and tables through ``repro_torch.convert``,
and the venice/baseline lanes are held to the scalar oracle
``repro.ssd.scalar_ref.simulate_ref``.  The §3.1 probe runs at the full
8x8 geometry.
"""
import numpy as np
import pytest

import repro.ssd as J
from repro.ssd.designs import lower_designs as j_lower
from repro.ssd.scalar_ref import simulate_ref

from port_parity import assert_same_result, jax_reference, torch_threads
import repro_torch.ssd as P
from repro_torch.convert import lane_tables_from_numpy, transactions_from_numpy
from repro_torch.kernels.static_scan import mask_lists
from repro_torch.ssd.figs import sec31_example
from repro_torch.traces.generator import gen_trace, to_pages

DESIGNS = ("baseline", "pssd", "pnssd", "nossd", "venice", "ideal",
           "venice_minimal", "venice_hold")
SEEDS = (0, 5, 2, 9, 4, 1, 12, 3)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def port_case():
    """The port's own construction of the tiny fixtures (its generator,
    FTL and config)."""
    cfg = P.perf_optimized(rows=2, cols=2, pages_per_block=64)
    tr = dict(gen_trace("src2_1", 60, seed=3))
    tr["arrival_us"] = tr["arrival_us"] / 16.0
    pages = to_pages(tr, cfg.page_bytes)
    txns = P.decompose_trace(cfg, pages, footprint_pages=int(pages["footprint_pages"]))
    return cfg, txns


@pytest.fixture(scope="module")
def jax_results(tiny_cfg, tiny_txns):
    with jax_reference():
        return J.simulate_sweep(tiny_cfg, tiny_txns, DESIGNS, SEEDS)


@pytest.fixture(scope="module")
def port_results(port_case):
    cfg, txns = port_case
    return P.simulate_sweep(cfg, txns, DESIGNS, SEEDS, device="cpu")


@pytest.fixture(scope="module")
def port_results_converted(tiny_cfg, tiny_txns):
    cfg = P.perf_optimized(rows=2, cols=2, pages_per_block=64)
    txns = transactions_from_numpy(tiny_txns)
    tables = lane_tables_from_numpy(j_lower(tiny_cfg, DESIGNS))
    return P.simulate_sweep(cfg, txns, DESIGNS, SEEDS, device="cpu", tables=tables)


@pytest.mark.parametrize("i", range(len(DESIGNS)), ids=DESIGNS)
def test_sweep_matches_jax(i, port_results, jax_results):
    assert_same_result(port_results[i], jax_results[i])


@pytest.mark.parametrize("i", range(len(DESIGNS)), ids=DESIGNS)
def test_reference_inputs_through_convert(i, port_results_converted, jax_results):
    assert_same_result(port_results_converted[i], jax_results[i])


def test_fixture_exercises_conflicts_and_scouts(jax_results):
    by = {r.design: r for r in jax_results}
    assert by["baseline"].conflict.mean() > 0.2
    assert (by["venice"].tries > 1).any() and (by["venice"].hops > 0).any()
    assert (by["venice"].misroutes > 0).any()


@pytest.mark.parametrize("design", ["baseline", "venice"])
def test_scalar_oracle(design, port_case, tiny_cfg, tiny_txns):
    cfg, txns = port_case
    got = P.simulate(cfg, txns, design, seed=6, device="cpu")
    want = simulate_ref(tiny_cfg, tiny_txns, design, seed=6)  # scan order
    for f in ("completion", "wait", "conflict", "hops", "tries", "misroutes", "failed"):
        assert np.array_equal(getattr(got, f), want[f]), f
    assert got.bus_hold_ticks == int(want["bus_hold"].sum())
    assert got.link_hold_ticks == int(want["link_hold"].sum())


def test_sec31_probe_full_geometry():
    assert sec31_example(device="cpu") == (11.01, 7.01)


def test_kscout_not_ported(port_case):
    cfg, txns = port_case
    with pytest.raises(NotImplementedError, match="k-scout"):
        P.simulate(cfg, txns, "venice_kscout", device="cpu")


def test_lane_results_independent_of_sweep(port_case, port_results):
    cfg, txns = port_case
    solo = P.simulate(cfg, txns, "venice", seed=SEEDS[4], device="cpu")
    assert_same_result(solo, port_results[DESIGNS.index("venice")])
    assert np.all(solo.completion >= np.asarray(txns["arrival"])[np.argsort(
        P.sim._nominal_times(cfg, txns)[0], kind="stable")])


@pytest.mark.parametrize("geom", [(2, 2), (8, 8), (4, 16)])
def test_mask_lists_rebuild_the_combined_masks(geom):
    """The static kernel walks sorted resource-id lists built from the
    combined masks; they must hold exactly the masks' bits and fit the
    kernel's MAX_MASK (64)."""
    import torch

    cfg = P.perf_optimized(rows=geom[0], cols=geom[1])
    cmask = torch.from_numpy(P.lower_designs(cfg, ("baseline", "pssd", "pnssd",
                                                   "nossd", "ideal")).cmask)
    lists = mask_lists(cmask)
    assert lists.dtype == torch.int32 and lists.shape[-1] <= 64
    rebuilt = torch.zeros(cmask.shape[:-1] + (cmask.shape[-1] + 1,), dtype=torch.bool)
    rebuilt.scatter_(-1, torch.where(lists < 0, cmask.shape[-1], lists).long(), True)
    assert torch.equal(rebuilt[..., :-1], cmask)
    assert torch.all(lists[..., 1:][lists[..., 1:] >= 0] > lists[..., :-1][lists[..., 1:] >= 0])
