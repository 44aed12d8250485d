"""Benchmark layer of the PyTorch port against the JAX reference.

``run_workload`` on a tiny geometry with a short trace: the accelerated
replay factor, every design's ``SimResult``, and the figure metrics built
on them (fig-9 speedup, fig-10 IOPS normalised to the ideal lane, fig-13
conflict rate) must be equal between ``repro_torch`` (plain versions on
the CPU) and ``repro``.  The port's batch entry point and figure tables are
checked against its own per-workload runs.
"""
import csv

import pytest

import repro.ssd as J
from repro.ssd import bench as jbench

from port_parity import assert_same_result, jax_reference, torch_threads
import repro_torch.ssd as P
from repro_torch.ssd import bench as pbench
from repro_torch.ssd.figs import fig9_10_13

DESIGNS = ("baseline", "pssd", "pnssd", "nossd", "venice", "ideal")
CASES = [("hm_0", "perf", 0), ("prxy_0", "cost", 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


def _cfgs(kind):
    kw = dict(rows=2, cols=2, pages_per_block=64)
    if kind == "perf":
        return P.perf_optimized(**kw), J.perf_optimized(**kw)
    return P.cost_optimized(**kw), J.cost_optimized(**kw)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for wl, kind, seed in CASES:
        cfg_p, cfg_j = _cfgs(kind)
        mine = pbench.run_workload(wl, cfg_p, DESIGNS, n_requests=50, seed=seed,
                                   device="cpu")
        with jax_reference():
            ref = jbench.run_workload(wl, cfg_j, DESIGNS, n_requests=50, seed=seed)
        out[(wl, kind)] = (mine, ref)
    return out


@pytest.mark.parametrize("wl,kind,seed", CASES)
def test_run_workload_metrics_match(wl, kind, seed, runs):
    mine, ref = runs[(wl, kind)]
    assert mine.accel == ref.accel and mine.n_requests == ref.n_requests
    for d in DESIGNS:
        assert_same_result(mine.results[d], ref.results[d])
        assert mine.speedup(d) == ref.speedup(d)
        assert mine.iops_norm(d) == ref.iops_norm(d)
        assert mine.results[d].conflict_rate() == ref.results[d].conflict_rate()
    assert pbench.geomean([mine.speedup(d) for d in DESIGNS]) == \
        jbench.geomean([ref.speedup(d) for d in DESIGNS])


def test_batch_entry_point_matches_single_runs(runs):
    reqs = [pbench.RunRequest(wl, _cfgs(kind)[0], DESIGNS, 50, seed=seed)
            for wl, kind, seed in CASES]
    stats = {}
    batch = pbench.run_workloads(reqs, device="cpu", stats=stats)
    launches = stats["launches"]
    assert [(L["kernel"], L["lanes"]) for L in launches] == \
        [("static_lane_scan", 10), ("scout_lane_scan", 2)]
    for rq, got in zip(reqs, batch):
        single = runs[(rq.name, rq.cfg.name)][0]
        for d in DESIGNS:
            assert_same_result(got.results[d], single.results[d])


def test_figure_tables(tmp_path):
    designs = ("baseline", "venice", "ideal")
    summary = fig9_10_13(("hm_0",), 12, csv_dir=str(tmp_path), designs=designs,
                         device="cpu")
    with open(tmp_path / "fig9_speedup.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["config", "workload", "design", "speedup"]
    assert [r[:3] for r in rows[1:]] == [[c, "hm_0", d] for c in ("perf", "cost")
                                         for d in designs]
    single = pbench.run_workload("hm_0", P.perf_optimized(), designs, 12, device="cpu")
    assert summary["perf"]["venice"] == single.speedup("venice")
    assert rows[2][3] == f"{single.speedup('venice'):.3f}"
    for name, header in (("fig10_iops.csv", "iops_norm_ideal"),
                         ("fig13_conflicts.csv", "conflict_pct")):
        with open(tmp_path / name) as f:
            got = list(csv.reader(f))
        assert got[0][-1] == header and len(got) == 1 + 2 * len(designs)
