"""Discrete-resource SSD simulator: host preparation and the lane-scan entry points.

Every design in ``designs.REGISTRY`` lowers to padded tables over a unified
resource vector ``[links | FCs | chips]``; one *lane* is one (run, design)
pair scanning its page transactions in nominal order against its resource
state.  Lanes fall in two cost classes, and each class runs as ONE kernel
launch for every lane of the call — across designs, workloads and configs:

* statically-routed lanes (baseline, pssd, pnssd, nossd, ideal) —
  ``kernels.static_scan.static_lane_scan``;
* scout-routed lanes (venice, venice_minimal, venice_hold) —
  ``kernels.scout.scout_lane_scan``, the Algorithm-1 scout fused with its
  DFS and retry loop.

The host stages — nominal ordering, packing and the ``SimResult``
reductions — are numpy, as in the JAX reference (``repro.ssd.sim``), whose
outputs this module reproduces element by element.  Entry points run on the
GPU unless the caller passes ``device="cpu"``; which implementation runs is
decided by the tensors' device alone (CUDA tensors launch the kernels, CPU
tensors take their plain PyTorch versions).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.topology import build_mesh
from repro_torch.kernels import ref as kref
from repro_torch.kernels.scout import scout_lane_scan
from repro_torch.kernels.static_scan import static_lane_scan
from repro_torch.ssd.config import SSDConfig, TICK_NS
from repro_torch.ssd.designs import (
    DESIGNS,
    KIND_SCOUT,
    REGISTRY,
    LaneTables,
    lower_designs,
    resolve_specs,
    sweep_layout,
)

__all__ = [
    "DESIGNS", "TxnArrays", "StepOut", "SimResult", "simulate",
    "simulate_sweep", "resolve_device",
]

KIND_READ, KIND_WRITE, KIND_ERASE = 0, 1, 2


class TxnArrays(NamedTuple):
    """Page-level transactions in scan order (numpy)."""

    arrival: np.ndarray  # int32 [n]
    kind: np.ndarray  # int32 [n] 0=read 1=write 2=erase
    plane: np.ndarray  # int32 [n] global plane id
    node: np.ndarray  # int32 [n] chip / mesh node id
    row: np.ndarray  # int32 [n] channel id
    nbytes: np.ndarray  # int32 [n]
    op_ticks: np.ndarray  # int32 [n] tR/tPROG/tBERS by kind
    valid: np.ndarray  # bool  [n]


class StepOut(NamedTuple):
    completion: np.ndarray  # int32 ticks
    wait: np.ndarray  # int32 ticks spent waiting on the path (conflict time)
    conflict: np.ndarray  # bool — experienced a path conflict (fig. 13)
    hops: np.ndarray  # int32 (mesh designs; 0 for bus designs)
    tries: np.ndarray  # int32 scout attempts (venice)
    scout_steps: np.ndarray  # int32 DFS steps (venice)
    misroutes: np.ndarray  # int32 non-minimal hops on final path (venice)
    bus_hold: np.ndarray  # int32 ticks a shared bus was held
    link_hold: np.ndarray  # int32 link-ticks (sum over links held)
    failed: np.ndarray  # bool — permanent reservation failure (dead path)


class SimResult(NamedTuple):
    design: str
    completion: np.ndarray  # ticks, per txn
    latency: np.ndarray  # ticks, per txn
    req_latency: np.ndarray  # ticks, per host request (GC excluded)
    wait: np.ndarray
    conflict: np.ndarray
    hops: np.ndarray
    tries: np.ndarray
    misroutes: np.ndarray
    exec_ticks: int
    bus_hold_ticks: int
    link_hold_ticks: int
    flash_energy_j: float
    transfer_energy_j: float
    static_energy_j: float
    req_completion: np.ndarray | None = None  # ticks, max over request's txns
    req_tenant: np.ndarray | None = None  # tenant id per request, or None
    failed: np.ndarray | None = None  # bool per txn — permanent path failure
    req_failed: np.ndarray | None = None  # bool per request (any txn failed)

    @property
    def exec_s(self) -> float:
        return self.exec_ticks * TICK_NS * 1e-9

    def iops(self, n_requests: int | None = None) -> float:
        n = len(self.req_latency) if n_requests is None else n_requests
        return n / max(self.exec_s, 1e-12)

    def conflict_rate(self) -> float:
        return float(np.mean(self.conflict))


# ---------------------------------------------------------------------------
# host preparation (numpy, identical to the JAX reference)
# ---------------------------------------------------------------------------


def _nominal_times(cfg: SSDConfig, txns, avail0: np.ndarray | None = None):
    """Nominal per-txn readiness times (FIFO per plane, zero network
    contention) plus the post-stream per-plane availability.

    A grouped-cumsum pass: per plane, ``avail' = max(arrival, avail) + d``
    unrolls to ``avail_k = max(avail0_p, max_{j<k}(arrival_j - D_j)) + D_k``
    with ``D`` the in-plane exclusive prefix sum of the durations ``d``.
    Returns ``(nominal int64 [n], avail_out int64 [n_planes])``.
    """
    arrival = np.asarray(txns["arrival"], dtype=np.int64)
    n = len(arrival)
    out_avail = (np.zeros((cfg.n_planes,), dtype=np.int64)
                 if avail0 is None else np.asarray(avail0, np.int64).copy())
    if n == 0:
        return np.empty((0,), dtype=np.int64), out_avail
    kind = np.asarray(txns["kind"])
    plane = np.asarray(txns["plane"])
    nbytes = np.asarray(txns["nbytes"], dtype=np.int64)
    xfer_est = nbytes // TICK_NS  # ~1 B/ns
    t_r, t_w, t_e = cfg.t_read, cfg.t_prog, cfg.t_erase
    d = np.where(
        kind == KIND_READ, 1 + t_r + xfer_est,
        np.where(kind == KIND_WRITE, xfer_est + t_w, np.int64(t_e)),
    ).astype(np.int64)
    # contiguous plane groups, (arrival, original index)-ordered within each
    o = np.lexsort((np.arange(n), arrival, plane))
    p_s, a_s, d_s = plane[o], arrival[o], d[o]
    start = np.empty(n, dtype=bool)
    start[0] = True
    start[1:] = p_s[1:] != p_s[:-1]
    excl = np.cumsum(d_s) - d_s
    D = excl - np.maximum.accumulate(np.where(start, excl, -1))
    v = a_s - D
    # segmented running max: adding rank*span keeps groups from mixing
    gid = np.cumsum(start) - 1
    span = np.int64(v.max()) - np.int64(v.min()) + 1
    m = np.maximum.accumulate(v + gid * span) - gid * span
    m_excl = np.empty(n, dtype=np.int64)
    m_excl[1:] = m[:-1]
    m_excl[start] = 0
    avail = np.maximum(m_excl, out_avail[p_s]) + D
    s = np.maximum(a_s, avail)
    nom_s = s + np.where(kind[o] == KIND_READ, np.int64(1 + t_r), 0)
    nominal = np.empty(n, dtype=np.int64)
    nominal[o] = nom_s
    ends = np.flatnonzero(np.concatenate((start[1:], [True])))
    out_avail[p_s[ends]] = np.maximum(a_s[ends], avail[ends]) + d_s[ends]
    return nominal, out_avail


def _nominal_order(cfg: SSDConfig, txns) -> np.ndarray:
    """Scan order: transactions by nominal network-transfer time, so the
    in-order commit is near-chronological (stable ties: decomposition
    order)."""
    nominal, _ = _nominal_times(cfg, txns)
    return np.argsort(nominal, kind="stable")


def _pack_txns(cfg: SSDConfig, txns, order: np.ndarray):
    """Reorder numpy transaction fields into scan-order ``TxnArrays``;
    returns ``(arrays, op_ticks)``."""
    n = len(order)

    def f(name, dtype):
        return np.asarray(txns[name])[order].astype(dtype)

    kind = f("kind", np.int32)
    op = np.where(
        kind == KIND_READ,
        cfg.t_read,
        np.where(kind == KIND_WRITE, cfg.t_prog, cfg.t_erase),
    ).astype(np.int32)
    arrs = TxnArrays(
        arrival=f("arrival", np.int32),
        kind=kind,
        plane=f("plane", np.int32),
        node=f("node", np.int32),
        row=f("row", np.int32),
        nbytes=f("nbytes", np.int32),
        op_ticks=op,
        valid=np.ones((n,), dtype=bool),
    )
    return arrs, op


def _finish_result(cfg: SSDConfig, design: str, txns, order,
                   op: np.ndarray, outs: StepOut, n: int) -> SimResult:
    """Numpy post-processing of one lane's scan outputs into a SimResult
    (float64 energies summed in the reference's order)."""
    completion = outs.completion[:n]
    arrival = np.asarray(txns["arrival"])[order]
    latency = completion - arrival
    exec_ticks = int(completion.max() - arrival.min()) if n else 0

    # host-request latency: completion of a request = max over its page txns
    req = np.asarray(txns["req"])[order]
    n_req = int(req.max()) + 1 if len(req) and req.max() >= 0 else 0
    req_done = np.zeros((n_req,), np.int64)
    req_arr = np.full((n_req,), np.iinfo(np.int64).max)
    host = req >= 0
    np.maximum.at(req_done, req[host], completion[host].astype(np.int64))
    np.minimum.at(req_arr, req[host], arrival[host].astype(np.int64))
    seen = req_arr < np.iinfo(np.int64).max
    req_latency = (req_done - req_arr)[seen]
    req_completion = req_done[seen]
    failed = np.asarray(outs.failed[:n], bool)
    req_fail = np.zeros((n_req,), bool)
    np.logical_or.at(req_fail, req[host], failed[host])
    req_failed = req_fail[seen]
    tenant = getattr(txns, "tenant_of_req", None)
    req_tenant = None
    if tenant is not None and len(tenant) >= n_req:
        req_tenant = np.asarray(tenant, np.int32)[:n_req][seen]

    pm = cfg.power
    tick_s = TICK_NS * 1e-9
    kind = np.asarray(txns["kind"])[order].astype(np.int32)
    die_w = np.where(
        kind == KIND_READ,
        pm.die_read_w,
        np.where(kind == KIND_WRITE, pm.die_prog_w, pm.die_erase_w),
    )
    flash_energy = float(np.sum(op.astype(np.float64) * tick_s * die_w))
    bus_hold = int(outs.bus_hold[:n].astype(np.int64).sum())
    link_hold = int(outs.link_hold[:n].astype(np.int64).sum())
    transfer_energy = (
        bus_hold * tick_s * pm.bus_active_w + link_hold * tick_s * pm.link_active_w
    )
    n_routers = REGISTRY[design].n_routers(build_mesh(cfg.rows, cfg.cols))
    static_energy = (pm.static_w + n_routers * pm.router_w) * exec_ticks * tick_s

    return SimResult(
        design=design,
        completion=completion,
        latency=latency,
        req_latency=req_latency,
        wait=outs.wait[:n],
        conflict=outs.conflict[:n],
        hops=outs.hops[:n],
        tries=outs.tries[:n],
        misroutes=outs.misroutes[:n],
        exec_ticks=exec_ticks,
        bus_hold_ticks=bus_hold,
        link_hold_ticks=link_hold,
        flash_energy_j=flash_energy,
        transfer_energy_j=float(transfer_energy),
        static_energy_j=float(static_energy),
        req_completion=req_completion,
        req_tenant=req_tenant,
        failed=failed,
        req_failed=req_failed,
    )


# ---------------------------------------------------------------------------
# lane-scan entry points
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default; the CPU only
    when the caller asks for it.  Never falls back quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the simulator runs on the GPU; pass "
                "device='cpu' to run the plain PyTorch versions instead")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is unavailable")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _i32_bits(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


class _Lane(NamedTuple):
    run_idx: int
    design_idx: int
    tab: int  # row of the pool's stacked tables
    txn_off: int
    n: int
    seed: int


class _Pool:
    """Lanes of one (geometry, cost class) and their deduplicated tables."""

    def __init__(self, cfg: SSDConfig):
        self.cfg = cfg
        self.lanes: list[_Lane] = []
        self.rows: list[tuple] = []  # (LaneTables, design index)
        self._tab_of: dict = {}

    def add(self, run_idx, i, tables: LaneTables, txn_off, n, seed):
        key = (id(tables), i)
        if key not in self._tab_of:
            self._tab_of[key] = len(self.rows)
            self.rows.append((tables, i))
        self.lanes.append(_Lane(run_idx, i, self._tab_of[key], txn_off, n, seed))

    def field(self, name: str) -> np.ndarray:
        return np.stack([np.asarray(getattr(t, name))[i] for t, i in self.rows])

    def scalars(self, names) -> np.ndarray:
        return np.stack([self.field(k).astype(np.int32) for k in names], axis=1)

    def lane_array(self, out_offs) -> np.ndarray:
        return np.asarray([(ln.tab, ln.txn_off, ln.n, o)
                           for ln, o in zip(self.lanes, out_offs)],
                          dtype=np.int32).reshape(-1, 4)


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def _timed(device, fn):
    """Run ``fn``; returns (result, milliseconds).  CUDA events on the card
    (the caller synchronises when it copies results back)."""
    if device.type == "cuda":
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        res = fn()
        ev1.record()
        ev1.synchronize()
        return res, ev0.elapsed_time(ev1)
    t0 = time.perf_counter()
    res = fn()
    return res, (time.perf_counter() - t0) * 1e3


class Launch(NamedTuple):
    """One kernel launch of a pool: the wrapper's name and its arguments
    (tables, lanes, transactions, zeroed lane state, output width)."""

    kernel: str  # "static_lane_scan" | "scout_lane_scan"
    pool: _Pool
    offs: np.ndarray  # output slot of each lane, then the total
    args: tuple


def _static_launch(pool: _Pool, txns_t, device) -> Launch:
    lay = sweep_layout(pool.cfg)
    tables = kref.StaticTables(
        scal=_t(pool.scalars(kref.STATIC_SCALARS), device),
        cmask=_t(pool.field("cmask"), device),
        hops=_t(pool.field("hops"), device, torch.int32),
        cand2=_t(pool.field("cand2_ok"), device),
        fc_fixed=_t(pool.field("fc_fixed"), device, torch.int32),
        dist=_t(pool.field("dist"), device, torch.int32),
        fc_valid=_t(pool.field("fc_valid"), device),
        res_dead=_t(pool.field("res_dead"), device),
    )
    offs = np.cumsum([0] + [ln.n for ln in pool.lanes])
    lanes = _t(pool.lane_array(offs[:-1]), device)
    B = len(pool.lanes)
    plane_free = torch.zeros((B, pool.cfg.n_planes), dtype=torch.int32,
                             device=device)
    res = torch.zeros((B, 3, lay.R_pad), dtype=torch.int32, device=device)
    return Launch("static_lane_scan", pool, offs,
                  (tables, lanes, txns_t, plane_free, res, int(offs[-1])))


def _scout_launch(pool: _Pool, txns_t, device) -> Launch:
    cfg = pool.cfg
    lay = sweep_layout(cfg)
    if np.any(pool.field("n_scouts") > 1):
        raise NotImplementedError(
            "k-scout lanes (n_scouts > 1, venice_kscout) are not ported yet")
    topo = build_mesh(cfg.rows, cfg.cols)
    tables = kref.ScoutTables(
        scal=_t(pool.scalars(kref.SCOUT_SCALARS), device),
        dist=_t(pool.field("dist"), device, torch.int32),
        fc_valid=_t(pool.field("fc_valid"), device),
        fc_node=_t(pool.field("fc_node"), device, torch.int32),
        res_dead=_t(pool.field("res_dead"), device),
    )
    mesh = kref.MeshTables(
        port_link=_t(topo.port_link, device, torch.int32),
        port_neighbor=_t(topo.port_neighbor, device, torch.int32),
        cols=cfg.cols, scout_hop_ns=int(round(cfg.scout_flit_ns)),
    )
    offs = np.cumsum([0] + [ln.n for ln in pool.lanes])
    lanes = _t(pool.lane_array(offs[:-1]), device)
    B = len(pool.lanes)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    rng = _t(np.asarray([_i32_bits(ln.seed) for ln in pool.lanes], np.int32), device)
    return Launch("scout_lane_scan", pool, offs,
                  (tables, mesh, lanes, txns_t, z(B, cfg.n_planes),
                   z(B, 3, lay.L_pad), z(B, 3, cfg.rows), z(B, 3, lay.n_nodes),
                   rng, int(offs[-1])))


KERNELS = {"static_lane_scan": static_lane_scan, "scout_lane_scan": scout_lane_scan}


def plan_launches(runs: Sequence[tuple], device) -> tuple:
    """Host preparation of ``execute_runs``: order and pack every run's
    transactions, lower its designs and pool the lanes per (geometry, cost
    class).  Returns ``(prepared, launches)`` — per-run data for result
    assembly and one :class:`Launch` per pool."""
    device = torch.device(device)
    prepared, pools, txn_bufs, off = [], {}, [], 0
    for run_idx, run in enumerate(runs):
        cfg, txns, designs, seeds = run[:4]
        designs = tuple(designs)
        specs = resolve_specs(designs)
        tables = run[4] if len(run) > 4 and run[4] is not None \
            else lower_designs(cfg, designs)
        order = _nominal_order(cfg, txns)
        n = len(order)
        packed, op = _pack_txns(cfg, txns, order)
        prepared.append((cfg, txns, designs, order, op, n))
        txn_bufs.append(np.stack((packed.arrival, packed.kind, packed.plane,
                                  packed.node, packed.nbytes, packed.op_ticks)))
        geom = (cfg.rows, cfg.cols, cfg.dies_per_chip, cfg.planes_per_die,
                int(round(cfg.scout_flit_ns)))
        for i, spec in enumerate(specs):
            key = (geom, spec.kind == KIND_SCOUT)
            pool = pools.setdefault(key, _Pool(cfg))
            pool.add(run_idx, i, tables, off, n, int(seeds[i]) | 1)
        off += n
    txns_t = _t(np.concatenate(txn_bufs, axis=1) if txn_bufs
                else np.zeros((6, 0), np.int32), device, torch.int32)
    launches = [(_scout_launch if scout else _static_launch)(pool, txns_t, device)
                for (_, scout), pool in pools.items()]
    return prepared, launches


def execute_runs(runs: Sequence[tuple], device=None,
                 stats: dict | None = None) -> list:
    """Simulate many sweeps with one kernel launch per (geometry, cost
    class).

    ``runs``: iterable of ``(cfg, txns, designs, seeds)`` with ``seeds`` a
    per-lane tuple, optionally extended by a ``LaneTables`` (stacked over
    ``designs``) that replaces the lowering.  Returns per-run lists of
    :class:`SimResult` in design order.  ``stats``, when given, receives
    the host seconds (``host_prep_s``, ``host_finish_s``) and per launch
    the kernel, lanes, lane-transactions and milliseconds (CUDA events on
    the card; the host clock around the plain versions on the CPU)."""
    device = resolve_device(device)
    t_host = time.perf_counter()
    prepared, launches = plan_launches(runs, device)
    if stats is None:
        stats = {}
    stats.update(device=str(device), host_prep_s=time.perf_counter() - t_host,
                 launches=[])
    outs: dict = {}
    for launch in launches:
        out, ms = _timed(device, lambda: KERNELS[launch.kernel](*launch.args))
        out = out.cpu().numpy()
        stats["launches"].append({"kernel": launch.kernel,
                                  "lanes": len(launch.pool.lanes),
                                  "txns": int(launch.offs[-1]), "ms": ms})
        for ln, o in zip(launch.pool.lanes, launch.offs[:-1]):
            outs[(ln.run_idx, ln.design_idx)] = out[:, o:o + ln.n]

    t_fin = time.perf_counter()
    results = []
    for run_idx, (cfg, txns, designs, order, op, n) in enumerate(prepared):
        run_res = []
        for i, design in enumerate(designs):
            o = outs[(run_idx, i)]
            step = StepOut(
                completion=o[0], wait=o[1], conflict=o[2].astype(bool),
                hops=o[3], tries=o[4], scout_steps=o[5], misroutes=o[6],
                bus_hold=o[7], link_hold=o[8], failed=o[9].astype(bool))
            run_res.append(_finish_result(cfg, design, txns, order, op, step, n))
        results.append(run_res)
    stats["host_finish_s"] = time.perf_counter() - t_fin
    return results


def simulate_sweep(
    cfg: SSDConfig,
    txns,
    designs: Sequence[str] = DESIGNS,
    seeds: int | Sequence[int] = 0,
    device=None,
    tables: LaneTables | None = None,
) -> list[SimResult]:
    """Run a design sweep: every lane of a cost class in one launch.

    ``txns`` holds numpy fields arrival (ticks), kind, plane, node, row,
    nbytes, req (see ``repro_torch.ssd.ftl``).  ``designs`` are registry
    names (a name may repeat); ``seeds`` is one int for every lane or a
    per-lane sequence (each lane's scout stream starts at ``seed | 1``).
    ``tables`` (stacked over ``designs``) replaces the lowering — a test
    feeds the JAX package's own tables through ``repro_torch.convert``.
    Returns SimResults in lane order."""
    designs = tuple(designs)
    resolve_specs(designs)
    if isinstance(seeds, (int, np.integer)):
        seeds = (int(seeds),) * len(designs)
    seeds = tuple(int(s) for s in seeds)
    if len(seeds) != len(designs):
        raise ValueError(f"got {len(seeds)} seeds for {len(designs)} design lanes")
    return execute_runs([(cfg, txns, designs, seeds, tables)], device)[0]


def simulate(cfg: SSDConfig, txns, design: str, seed: int = 0,
             device=None) -> SimResult:
    """Run one (config, design) simulation — a 1-lane design sweep."""
    return simulate_sweep(cfg, txns, (design,), (seed,), device=device)[0]
