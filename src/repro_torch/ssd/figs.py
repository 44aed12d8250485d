"""Figure tables of the main path: fig 9/10/13 and the §3.1 probe.

Counterparts of ``benchmarks/run.py::fig4_and_9_and_10_and_13`` and
``sec31_example``, writing the same CSV files in the same format.  The
figure sweep hands every (workload, config) pair to one
``bench.run_workloads`` call, so the whole preset runs as one kernel
launch per cost class.
"""
from __future__ import annotations

import csv
import os

import numpy as np

from repro_torch.ssd.bench import RunRequest, geomean, run_workloads
from repro_torch.ssd.config import cost_optimized, perf_optimized
from repro_torch.ssd.sim import simulate

QUICK_WL = ("proj_3", "src2_1", "hm_0", "prxy_0", "YCSB_B", "ssd-10", "usr_0")
DEFAULT_DESIGNS = ("baseline", "pssd", "pnssd", "nossd", "venice", "ideal")
N_REQ_QUICK = 2500


def _rows_to_csv(path, header, rows):
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)


def fig9_10_13(workloads=QUICK_WL, n_req: int = N_REQ_QUICK, csv_dir=None,
               designs=DEFAULT_DESIGNS, device=None, stats: dict | None = None) -> dict:
    """Speedups over baseline (fig 9), IOPS normalised to the ideal lane
    (fig 10) and conflict rates (fig 13) for the perf- and cost-optimized
    configs.  Writes the CSVs into ``csv_dir`` when given; ``stats`` is
    passed to ``run_workloads``.  Returns ``{config: {design: geomean
    speedup}}``."""
    designs = tuple(designs)
    cfgs = (perf_optimized(), cost_optimized())
    runs = run_workloads([RunRequest(wl, cfg, designs, n_req)
                          for cfg in cfgs for wl in workloads], device, stats)
    rows9, rows10, rows13 = [], [], []
    summary = {}
    has_ideal = "ideal" in designs
    it = iter(runs)
    for cfg in cfgs:
        sp = {d: [] for d in designs}
        for wl in workloads:
            r = next(it)
            for d in designs:
                s = r.speedup(d)
                sp[d].append(s)
                rows9.append([cfg.name, wl, d, f"{s:.3f}"])
                if has_ideal:
                    rows10.append([cfg.name, wl, d, f"{r.iops_norm(d):.3f}"])
                rows13.append([cfg.name, wl, d,
                               f"{r.results[d].conflict_rate()*100:.2f}"])
        summary[cfg.name] = {d: geomean(sp[d]) for d in designs}
    if csv_dir:
        _rows_to_csv(os.path.join(csv_dir, "fig9_speedup.csv"),
                     ["config", "workload", "design", "speedup"], rows9)
        if has_ideal:
            _rows_to_csv(os.path.join(csv_dir, "fig10_iops.csv"),
                         ["config", "workload", "design", "iops_norm_ideal"],
                         rows10)
        _rows_to_csv(os.path.join(csv_dir, "fig13_conflicts.csv"),
                     ["config", "workload", "design", "conflict_pct"], rows13)
    return summary


def sec31_example(csv_dir=None, device=None) -> tuple:
    """§3.1: two 4 KB reads on one channel (paper 11.01 µs) and on two
    channels (paper 7.01 µs) through the baseline design; returns the two
    service times in µs."""
    cfg = perf_optimized(bus_protocol_ovh_ns=0.0, chan_gbps=1.024)

    def mk(planes):
        n = len(planes)
        planes = np.asarray(planes, np.int64)
        chips = planes // 2
        return {
            "arrival": np.zeros(n, np.int64), "kind": np.zeros(n, np.int64),
            "plane": planes, "node": chips, "row": chips // cfg.cols,
            "nbytes": np.full(n, 4096, np.int64),
            "req": np.arange(n, dtype=np.int64),
        }

    conflict = simulate(cfg, mk([0, 2]), "baseline", device=device).exec_ticks / 100
    free = simulate(cfg, mk([0, 16]), "baseline", device=device).exec_ticks / 100
    if csv_dir:
        _rows_to_csv(os.path.join(csv_dir, "sec31_example.csv"),
                     ["case", "us", "paper_us"],
                     [["same_channel", f"{conflict:.2f}", 11.01],
                      ["different_channels", f"{free:.2f}", 7.01]])
    return conflict, free
