#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; exits non-zero
(printing no result) without one, or when the port's sources are missing.
Phases, one line each, any failure aborts:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (timed),
   print the card's name and power limit;
2. ``scout_step`` against ``scout_step_ref``: 8192 seeded random scouts on
   the 8x8 mesh, both ``allow_nonminimal`` values — exact equality;
3. ``static_lane_scan`` and ``scout_lane_scan`` against their plain
   versions on the same card: the six designs at 8x8 on ``hm_0`` (240
   requests) for the perf and cost configs — every output and the final
   lane state equal — and the same on 4x16, 16x4 and 2x3 meshes (60
   requests);
4. the §3.1 probe through ``simulate`` on the card: 11.01 / 7.01 us;
5. the main path: the quick preset (7 workloads x {perf, cost} x six
   designs x 2500 requests) through ``run_workloads`` and the figure
   tables — geomean speedups, host/device time, lanes and transactions
   per launch; the launch counters are zeroed before and read after;
6. one JSON line of per-kernel numbers, the card's name and power limit,
   and the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_INT_OPS_PER_S = 67e12  # non-tensor 32-bit rate (the float32 figure)
QUICK_REQ = 2500
SMOKE_REQ = 240
# the JAX package's own quick-preset run (same workloads, designs, requests
# and seeds): its geomean speedups, rounded to 4 places, are what the main
# path must reproduce
REFERENCE_RUN = os.path.join(ROOT, "results", "BENCH_20260808_scoutlanes_warm.json")
DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu" (kernels then take their plain versions)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int = 3):
    """Median milliseconds of ``fn`` (CUDA events); returns (result, ms)."""
    import torch

    res, times = None, []
    for _ in range(reps):
        if DEVICE == "cpu":
            t0 = time.perf_counter()
            res = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        res = fn()
        ev1.record()
        ev1.synchronize()
        times.append(ev0.elapsed_time(ev1))
    return res, sorted(times)[len(times) // 2]


def sync() -> None:
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 2: one Algorithm-1 decision per scout
# ---------------------------------------------------------------------------


def scout_batch(B: int, seed: int):
    import numpy as np
    import torch

    from repro_torch.core.topology import build_mesh

    topo = build_mesh(8, 8)
    rs = np.random.RandomState(seed)
    state = np.zeros((B, 8), np.int32)
    state[:, 0] = rs.randint(0, topo.n_nodes, B)
    state[:, 1] = rs.randint(0, topo.n_nodes, B)
    state[:, 2] = rs.randint(-1, 4, B)
    state[:, 3] = rs.randint(-2**31, 2**31 - 1, B, dtype=np.int64)
    busy = np.zeros((B, 128), np.int32)
    density = rs.rand(B, 1)
    busy[:, :topo.n_links] = rs.rand(B, topo.n_links) < density
    tried = (rs.rand(B, 4 * topo.n_nodes) < density / 2).astype(np.int32)
    dev = torch.device(DEVICE)
    return (torch.from_numpy(state).to(dev), torch.from_numpy(busy).to(dev),
            torch.from_numpy(tried).to(dev),
            torch.from_numpy(topo.port_link).to(dev),
            torch.from_numpy(topo.port_neighbor).to(dev), topo.cols)


def phase_decisions(report: dict) -> None:
    from repro_torch.kernels.ref import scout_step_ref
    from repro_torch.kernels.scout import scout_step

    B = 8192
    for allow in (True, False):
        args = scout_batch(B, seed=12 + int(allow))
        got, ms = time_cuda(lambda: scout_step(*args, allow_nonminimal=allow))
        want, plain_ms = time_cuda(lambda: scout_step_ref(*args, allow_nonminimal=allow))
        for g, w, name in zip(got, want, ("state", "busy", "tried")):
            if not bool((g == w).all()):
                fail(f"scout_step {name} differs from scout_step_ref (allow={allow})")
        moved = nbytes(*args[:5]) + nbytes(*got)
        ops = 40 * B + 2 * (args[1].numel() + args[2].numel())  # decision + row copies
        if allow:
            report["scout_step"] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=0, bytes=moved, ops=ops,
                shape=f"{B} scouts, 8x8 mesh, busy [B,128], tried [B,256]")
    print(f"[phase 2] scout_step == scout_step_ref: {B} scouts x allow_nonminimal "
          f"{{True, False}} exact; kernel {report['scout_step']['ms']:.4f} ms, "
          f"plain {report['scout_step']['plain_ms']:.3f} ms", flush=True)


# ---------------------------------------------------------------------------
# phase 3: lane scans against their plain versions
# ---------------------------------------------------------------------------


def _clone_args(args):
    import torch

    return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)


def _work_static(args, out):
    """Bytes each input read once / output written once, and an operation
    count from this run's data: per transaction 60 + 10 per flash controller
    + 64 per resource on the two candidate paths."""
    import torch

    from repro_torch.kernels.static_scan import mask_lists

    tables, lanes, txns, plane_free, res, n_out = args
    midx = mask_lists(tables.cmask)
    per_path = (midx >= 0).sum(dim=-1)  # [T, F0, N, 2]
    F0 = tables.dist.shape[1]
    moved = (nbytes(tables.scal, midx, tables.hops, tables.cand2, tables.fc_fixed,
                    tables.dist, tables.fc_valid, tables.res_dead, lanes, txns, out)
             + 2 * nbytes(plane_free, res))
    # candidate paths at the fixed FC of each transaction's node (nearest-FC
    # lanes: FC 0's path length stands for the chosen one)
    ops = 0
    for b in range(lanes.shape[0]):
        t, off, n = (int(v) for v in lanes[b, :3])
        nodes = txns[3, off:off + n].long()
        fc = tables.fc_fixed[t, nodes, 0].long()
        m = per_path[t, fc, nodes, 0] + per_path[t, fc, nodes, 1]
        ops += int(n * (60 + 10 * F0) + 64 * int(m.sum()))
    return moved, ops


def _work_scout(args, out):
    """Bytes as above; operations from this run's outputs: per transaction
    60 + 10 per FC, per try 12 per link (busy map, next event), per DFS
    step of the final walk 40, per reserved hop 12."""
    tables, mesh, lanes, txns, plane_free, links, fcs, chips, rng, n_out = args
    L0, NF = links.shape[2], fcs.shape[2]
    moved = (nbytes(*tables, mesh.port_link, mesh.port_neighbor, lanes, txns, out)
             + 2 * nbytes(plane_free, links, fcs, chips, rng))
    tries, steps, hops = out[4].long().sum(), out[5].long().sum(), out[3].long().sum()
    ops = int(n_out * (60 + 10 * NF) + 12 * L0 * int(tries) + 40 * int(steps)
              + 12 * int(hops))
    return moved, ops


def _lane_launches(geom, n_req: int):
    """The kernel launches of the figure sweep for ``hm_0`` on one mesh:
    perf and cost configs, six designs, as ``run_workloads`` builds them."""
    from repro_torch.ssd import sim
    from repro_torch.ssd.bench import RunRequest, accelerate
    from repro_torch.ssd.config import cost_optimized, perf_optimized
    from repro_torch.ssd.figs import DEFAULT_DESIGNS
    from repro_torch.ssd.ftl import decompose_trace
    from repro_torch.traces.generator import to_pages, trace_for

    runs = []
    for cfg in (perf_optimized(rows=geom[0], cols=geom[1]),
                cost_optimized(rows=geom[0], cols=geom[1])):
        rq = RunRequest("hm_0", cfg, DEFAULT_DESIGNS, n_req)
        trace, _ = accelerate(trace_for(rq.name, n_req, rq.seed), cfg, rq.target_util)
        pages = to_pages(trace, cfg.page_bytes)
        txns = decompose_trace(cfg, pages, int(pages["footprint_pages"]))
        runs.append((cfg, txns, rq.designs, (rq.seed + 7,) * len(rq.designs)))
    return sim.plan_launches(runs, DEVICE)[1]


def _hold_to_plain(launch):
    """Run a launch through its kernel and its plain version on the same
    inputs; fail unless every output and the final lane state are equal.
    Returns (kernel output, plain milliseconds)."""
    import torch

    from repro_torch.kernels.ref import scout_lane_scan_ref, static_lane_scan_ref
    from repro_torch.ssd import sim

    plain = {"static_lane_scan": static_lane_scan_ref,
             "scout_lane_scan": scout_lane_scan_ref}[launch.kernel]
    k_args = _clone_args(launch.args)
    got = sim.KERNELS[launch.kernel](*k_args)
    sync()
    p_args = _clone_args(launch.args)
    t0 = time.perf_counter()
    want = plain(*p_args)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not bool((got == want).all()):
        bad = (got != want).any(dim=1).nonzero().flatten().tolist()
        fail(f"{launch.kernel} output fields {bad} differ from the plain version")
    for a, b in zip(k_args, p_args):
        if isinstance(a, torch.Tensor) and not bool((a == b).all()):
            fail(f"{launch.kernel} final lane state differs from the plain version")
    return got, plain_ms


def phase_lane_scans(report: dict) -> None:
    from repro_torch.ssd import sim

    for launch in _lane_launches((8, 8), SMOKE_REQ):
        got, plain_ms = _hold_to_plain(launch)
        kernel = sim.KERNELS[launch.kernel]
        _, ms = time_cuda(lambda: kernel(*_clone_args(launch.args)))
        work = _work_static if launch.kernel == "static_lane_scan" else _work_scout
        moved, ops = work(launch.args, got)
        report[launch.kernel] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=0, bytes=moved, ops=ops,
            shape=f"{len(launch.pool.lanes)} lanes, {int(launch.offs[-1])} lane-txns, "
                  f"8x8, hm_0 x {SMOKE_REQ} req, perf+cost")
        print(f"[phase 3] {launch.kernel} == plain version: "
              f"{len(launch.pool.lanes)} lanes, {int(launch.offs[-1])} lane-transactions, "
              f"all 10 outputs + lane state exact; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms", flush=True)
    # the other meshes of the paper's fig 15 and a small non-square one
    for geom in ((4, 16), (16, 4), (2, 3)):
        for launch in _lane_launches(geom, 60):
            _hold_to_plain(launch)
        print(f"[phase 3] {geom[0]}x{geom[1]} mesh, hm_0 x 60 req, perf+cost: both "
              f"lane scans == plain versions", flush=True)


# ---------------------------------------------------------------------------
# phases 4-5: the probe and the main path
# ---------------------------------------------------------------------------


def phase_probe() -> None:
    from repro_torch.ssd.figs import sec31_example

    conflict, free = sec31_example(device=DEVICE)
    if (conflict, free) != (11.01, 7.01):
        fail(f"sec3.1 probe gave {conflict}/{free} us, expected 11.01/7.01")
    print(f"[phase 4] sec3.1 probe on the card: same channel {conflict:.2f} us, "
          f"different channels {free:.2f} us (paper 11.01 / 7.01)", flush=True)


def phase_main(report: dict, card: str, n_req: int) -> None:
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.ssd.figs import DEFAULT_DESIGNS, QUICK_WL, fig9_10_13

    build.reset_launches()
    times: dict = {}
    t0 = time.perf_counter()
    summary = fig9_10_13(QUICK_WL, n_req, csv_dir=OUT_DIR, device=DEVICE, stats=times)
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for name in ("static_lane_scan", "scout_lane_scan"):
        if launches[name] < 1 and DEVICE != "cpu":
            fail(f"the main path never launched {name}")
        report[name]["launches"] = launches[name]
    report["scout_step"]["launches"] = launches["scout_step"]
    for cfg, g in summary.items():
        for d in DEFAULT_DESIGNS:
            if not (math.isfinite(g[d]) and g[d] > 0):
                fail(f"geomean speedup {cfg}/{d} = {g[d]}")
        if abs(g["baseline"] - 1.0) > 1e-12:
            fail(f"baseline speedup over itself is {g['baseline']}")
        print(f"[phase 5] fig9/{cfg} geomean speedups: "
              + " ".join(f"{d}={g[d]:.2f}x" for d in DEFAULT_DESIGNS), flush=True)
    device_ms = sum(L["ms"] for L in times["launches"])
    host_s = times["trace_ftl_s"] + times["host_prep_s"] + times["host_finish_s"]
    for L in times["launches"]:
        report[L["kernel"]]["main_path_ms"] = L["ms"]
        print(f"[phase 5] launch {L['kernel']}: {L['lanes']} lanes, "
              f"{L['txns']} lane-transactions, {L['ms']:.3f} ms", flush=True)
    print(f"[phase 5] quick preset ({len(QUICK_WL)} workloads x 2 configs x "
          f"{len(DEFAULT_DESIGNS)} designs x {n_req} requests) wall {wall:.3f} s: "
          f"host {host_s:.3f} s (trace+FTL {times['trace_ftl_s']:.3f}, lowering+packing "
          f"{times['host_prep_s']:.3f}, results {times['host_finish_s']:.3f}), "
          f"device {device_ms / 1e3:.3f} s (kernels); card {card}", flush=True)
    with open(REFERENCE_RUN) as f:
        ref = json.load(f)
    if (ref["n_req"], ref["workloads"], ref["designs"]) != (n_req, list(QUICK_WL),
                                                           list(DEFAULT_DESIGNS)):
        fail(f"{REFERENCE_RUN} is not the quick preset this phase runs")
    for cfg, g in summary.items():
        mine = {d: round(g[d], 4) for d in DEFAULT_DESIGNS}
        if mine != ref["speedups_geomean"][cfg]:
            fail(f"fig9/{cfg} geomeans {mine} differ from the JAX package's "
                 f"{ref['speedups_geomean'][cfg]} ({os.path.basename(REFERENCE_RUN)})")
    print(f"[phase 5] geomeans equal the JAX package's quick-preset run to 4 places "
          f"({os.path.relpath(REFERENCE_RUN, ROOT)})", flush=True)
    csvs = sorted(os.listdir(OUT_DIR))
    for f in ("fig9_speedup.csv", "fig10_iops.csv", "fig13_conflicts.csv"):
        if f not in csvs:
            fail(f"{f} was not written")
    rows = np.loadtxt(os.path.join(OUT_DIR, "fig9_speedup.csv"), delimiter=",",
                      skiprows=1, usecols=3)
    if rows.shape != (2 * len(QUICK_WL) * len(DEFAULT_DESIGNS),) or not np.isfinite(rows).all():
        fail("fig9_speedup.csv has the wrong shape or non-finite values")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs the port on the GPU")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port's sources are not beside this script ({e})")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    build.library("scout")
    card = card_line()
    for name in build.LIBRARIES:
        ptxas = [ln.strip() for ln in build.BUILD_INFO.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        with open(os.path.join(OUT_DIR, f"ptxas_{name}.txt"), "w") as f:
            f.write(build.BUILD_INFO.get(name, ""))
        print(f"[phase 1] {name}: {' | '.join(ptxas) or 'built earlier'}", flush=True)
    print(f"[phase 1] kernels built in {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_INFO['directory']}); card: {card}", flush=True)

    report: dict = {}
    phase_decisions(report)
    phase_lane_scans(report)
    phase_probe()
    phase_main(report, card, QUICK_REQ)

    replaces = {
        "static_lane_scan": ("src/repro_torch/kernels/csrc/static_scan.cu",
                             "src/repro/kernels/batched_step.py:52"),
        "scout_lane_scan": ("src/repro_torch/kernels/csrc/scout.cu",
                            "src/repro/kernels/scout_step.py:219"),
        "scout_step": ("src/repro_torch/kernels/csrc/scout.cu",
                       "src/repro/kernels/scout_step.py:219"),
    }
    kernels = []
    for name, (source, old) in replaces.items():
        r = report[name]
        t_bytes = r["bytes"] / H100_BYTES_PER_S * 1e3
        t_ops = r["ops"] / H100_INT_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": old,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "measured_on": r["shape"],
            "main_path_ms": r.get("main_path_ms"),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
