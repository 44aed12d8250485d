"""Declarative design registry: every interconnect design lowers to tables.

A :class:`DesignSpec` describes one interconnect design (shared-bus groups,
link tables, routing mode, bandwidth multipliers, scout parameters) and
:func:`lower_designs` lowers any set of specs into one *common padded array
layout* (:class:`LaneTables`, numpy) consumed by the lane-scan kernels.
Because every design is data — not code — one kernel launch serves every
lane of a cost class, and adding a design is a spec here.

Unified resource space
  Every time-shared resource lives in one padded vector of length ``R_pad``:

      [ 0, L_pad )                 links   (mesh links / shared buses)
      [ L_pad, L_pad+F_pad )       flash controllers
      [ L_pad+F_pad, R_pad )       chip I/O interfaces

  A design's route is a boolean *combined mask* over this vector: a shared
  bus is a 1-link "mesh" with routing disabled (its mask holds exactly one
  link bit), pnSSD's two bus paths are two candidate masks, NoSSD's XY path
  is a multi-link mask, and Venice's path is found at runtime by the
  Algorithm-1 scout.

Timing tables
  Transfer time is one rational formula per design,
  ``ns = ceil(nbytes * xfer_num / xfer_den) + hops * hop_ns`` (then ticks =
  ceil(ns / TICK_NS)), which reproduces both the shared-channel rate
  (xfer_num/xfer_den = 1000 / round(GB/s * 1000), hop_ns = 0) and the mesh
  Eq. (1) link rate (1 B/ns, +1 ns pipeline fill per hop).

Ablations (each documented next to its spec in ``REGISTRY``):
  venice_minimal  Algorithm 1 restricted to minimal-adaptive routing.
  venice_hold     the circuit is reserved across CMD + tR + transfer.
  venice_kscout   3 scouts race per reservation (lowered here; the lane scan
                  of this package runs one scout per reservation and refuses
                  ``n_scouts > 1``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.topology import MeshTopology, all_xy_paths, build_mesh
from repro_torch.ssd.config import SSDConfig, TICK_NS

_BIG = np.int32(2**30)

KIND_BUS = "bus"
KIND_PNSSD = "pnssd"
KIND_NOSSD = "nossd"
KIND_SCOUT = "scout"
_KINDS = (KIND_BUS, KIND_PNSSD, KIND_NOSSD, KIND_SCOUT)


@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """One interconnect design, declaratively.

    ``kind`` selects the lowering recipe (how the tables are built); all
    runtime behaviour differences between designs of the same kind are pure
    data in :class:`LaneTables`.
    """

    name: str
    kind: str  # one of _KINDS
    doc: str = ""
    # --- bus designs ---
    chan: str = "row"  # "row": one bus per channel; "node": private per chip
    bw_mult: float = 1.0  # channel bandwidth multiplier (pSSD: 2x)
    bus_ovh: bool = False  # pays cfg.t_bus_ovh per bus phase (legacy ONFI)
    # --- scout (Venice) designs ---
    allow_nonminimal: bool = True  # Algorithm-1 misrouting enabled
    hold_during_op: bool = False  # keep one circuit across CMD+tR+transfer
    n_scouts: int = 1  # scouts raced per reservation (k-scout ablation)
    d_est_hops: int = 0  # hop margin in the availability-estimate duration
    d_est_pad: int = 0  # constant tick margin in the estimate

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown design kind {self.kind!r}")
        if self.n_scouts < 1:
            raise ValueError("n_scouts must be >= 1")

    @property
    def uses_mesh(self) -> bool:
        """Mesh-routed designs carry per-node routers (energy accounting)."""
        return self.kind in (KIND_NOSSD, KIND_SCOUT)

    @property
    def fc_nearest(self) -> bool:
        """Nearest-available FC selection (§4.2) vs fixed FC-per-channel."""
        return self.kind in (KIND_NOSSD, KIND_SCOUT)

    @property
    def counts_bus_energy(self) -> bool:
        """Occupancy billed as shared-bus hold (vs per-link hold)."""
        return self.kind in (KIND_BUS, KIND_PNSSD)

    def n_routers(self, topo: MeshTopology) -> int:
        return topo.n_nodes if self.uses_mesh else 0


REGISTRY: dict[str, DesignSpec] = {
    s.name: s
    for s in (
        DesignSpec(
            name="baseline", kind=KIND_BUS, chan="row", bus_ovh=True,
            doc="Multi-channel shared ONFI bus (Table 1): one bus per "
                "channel, per-phase protocol overhead.",
        ),
        DesignSpec(
            name="pssd", kind=KIND_BUS, chan="row", bw_mult=2.0,
            doc="Kim+ [15] pSSD: packetized channel (no ONFI overhead) at "
                "2x bandwidth.",
        ),
        DesignSpec(
            name="pnssd", kind=KIND_PNSSD,
            doc="Kim+ [15] pnSSD: row+column shared buses — two candidate "
                "paths per chip, FC i drives row bus i and column bus i.",
        ),
        DesignSpec(
            name="nossd", kind=KIND_NOSSD, d_est_hops=6,
            doc="Tavakkol+ [38] NoSSD: packet-switched 2D mesh, "
                "deterministic XY routing, nearest-available FC.",
        ),
        DesignSpec(
            name="venice", kind=KIND_SCOUT, d_est_hops=48, d_est_pad=16,
            doc="The paper (§4): per-transfer path reservation via "
                "Algorithm-1 scouts, non-minimal fully-adaptive.",
        ),
        DesignSpec(
            name="venice_minimal", kind=KIND_SCOUT, allow_nonminimal=False,
            d_est_hops=48, d_est_pad=16,
            doc="Ablation: Venice with minimal-only adaptive routing (no "
                "misroutes) — isolates non-minimal adaptivity's value.",
        ),
        DesignSpec(
            name="venice_hold", kind=KIND_SCOUT, hold_during_op=True,
            d_est_hops=48, d_est_pad=16,
            doc="Ablation: one circuit held across CMD + flash op + "
                "transfer — quantifies the link-hours the paper's "
                "per-transfer reservation recovers.",
        ),
        DesignSpec(
            name="venice_kscout", kind=KIND_SCOUT, n_scouts=3,
            d_est_hops=48, d_est_pad=16,
            doc="Beyond-paper k-scout: race 3 scouts with independent "
                "tie-break streams, commit the fewest-hop success.",
        ),
        DesignSpec(
            name="ideal", kind=KIND_BUS, chan="node", bus_ovh=True,
            doc="Path-conflict-free ideal: a private channel per chip "
                "(same ONFI protocol as baseline, just never shared).",
        ),
    )
}

DESIGNS = tuple(REGISTRY)


class SweepLayout(NamedTuple):
    """Static padded sizes of the unified resource space for one config."""

    rows: int
    cols: int
    n_nodes: int
    n_links: int  # mesh links of the underlying topology
    L_pad: int  # link section width (covers every design's link count)
    F_pad: int  # flash-controller section width
    R_pad: int  # total combined resource vector width


def sweep_layout_geom(rows: int, cols: int) -> SweepLayout:
    topo = build_mesh(rows, cols)
    L_pad = max(topo.n_links, topo.n_nodes, rows + cols, 1)
    F_pad = max(rows, cols)
    return SweepLayout(
        rows=rows,
        cols=cols,
        n_nodes=topo.n_nodes,
        n_links=topo.n_links,
        L_pad=L_pad,
        F_pad=F_pad,
        R_pad=L_pad + F_pad + topo.n_nodes,
    )


def sweep_layout(cfg: SSDConfig) -> SweepLayout:
    return sweep_layout_geom(cfg.rows, cfg.cols)


class LaneTables(NamedTuple):
    """Per-design tables (numpy), stacked on a leading design axis ``D``.

    All shapes depend only on the config, never on the design set.
    """

    # --- scalars [D] ---
    is_scout: np.ndarray  # bool — route via Algorithm-1 scout
    fc_nearest: np.ndarray  # bool — nearest-available FC selection (§4.2)
    ovh: np.ndarray  # int32 — per-bus-phase protocol overhead (ticks)
    cmd_base_ns: np.ndarray  # int32 — command packet ns before hop term
    xfer_num: np.ndarray  # int32 — transfer ns = ceil(B*num/den) + hops*hop_ns
    xfer_den: np.ndarray  # int32
    hop_ns: np.ndarray  # int32 — per-hop ns (0 for buses)
    allow_nonmin: np.ndarray  # bool — scout may misroute
    hold: np.ndarray  # bool — venice_hold circuit policy
    n_scouts: np.ndarray  # int32 — scouts raced per reservation
    d_est_hops: np.ndarray  # int32 — availability-estimate hop margin
    d_est_pad: np.ndarray  # int32 — availability-estimate tick margin
    count_bus: np.ndarray  # bool — bill occupancy as bus-hold
    # --- tables ---
    cmask: np.ndarray  # bool [D, F_pad, n_nodes, 2, R_pad] combined masks
    hops: np.ndarray  # int32 [D, F_pad, n_nodes, 2]
    cand2_ok: np.ndarray  # bool [D, n_nodes] — second candidate path valid
    fc_fixed: np.ndarray  # int32 [D, n_nodes, 2] — fixed FC per candidate
    dist: np.ndarray  # int32 [D, F_pad, n_nodes] — FC->chip distance
    fc_valid: np.ndarray  # bool [D, F_pad]
    fc_node: np.ndarray  # int32 [D, F_pad] — mesh injection node per FC
    res_dead: np.ndarray  # bool [D, R_pad] — failed resources (all False here)


def _lower_one(cfg: SSDConfig, topo: MeshTopology, lay: SweepLayout,
               spec: DesignSpec) -> dict:
    """Lower one spec to numpy tables in the unified padded layout."""
    rows, cols, N = lay.rows, lay.cols, lay.n_nodes
    L0, F0, R = lay.L_pad, lay.F_pad, lay.R_pad
    node_row = np.arange(N) // cols
    node_col = np.arange(N) % cols

    cmask = np.zeros((F0, N, 2, R), dtype=bool)
    hops = np.zeros((F0, N, 2), dtype=np.int32)
    cand2_ok = np.zeros((N,), dtype=bool)
    fc_fixed = np.zeros((N, 2), dtype=np.int32)
    dist = np.full((F0, N), _BIG, dtype=np.int32)
    fc_valid = np.zeros((F0,), dtype=bool)
    fc_valid[:rows] = True
    fc_node = np.zeros((F0,), dtype=np.int32)
    fc_node[:rows] = topo.fc_node

    # mesh manhattan distance from each FC's injection node (f, 0)
    mesh_dist = (
        np.abs(np.arange(rows)[:, None] - node_row[None, :]) + node_col[None, :]
    ).astype(np.int32)

    if spec.kind == KIND_BUS:
        link = node_row if spec.chan == "row" else np.arange(N)
        for n in range(N):
            cmask[:, n, :, link[n]] = True
        fc_fixed[:, 0] = fc_fixed[:, 1] = node_row
        dist[:rows] = 0
    elif spec.kind == KIND_PNSSD:
        # candidate 0: the chip's row bus, driven by FC row; candidate 1:
        # its column bus (ids rows..rows+cols-1), driven by FC col.  Both
        # candidates additionally occupy the chip's single I/O interface and
        # the owning FC (pnSSD adds path diversity, not transfer engines).
        for n in range(N):
            r, c = node_row[n], node_col[n]
            for cand, (lnk, fc) in enumerate(((r, r), (rows + c, c))):
                cmask[:, n, cand, lnk] = True
                cmask[:, n, cand, L0 + fc] = True
                cmask[:, n, cand, L0 + F0 + n] = True
            fc_fixed[n] = (r, c)
        cand2_ok[:] = True
        dist[:rows] = 0
    elif spec.kind == KIND_NOSSD:
        paths_np, hops_np = all_xy_paths(topo)
        for f in range(rows):
            for n in range(N):
                lk = paths_np[f, n]
                cmask[f, n, :, lk[lk >= 0]] = True
                cmask[f, n, :, L0 + f] = True
                cmask[f, n, :, L0 + F0 + n] = True
                hops[f, n] = hops_np[f, n]
        dist[:rows] = hops_np  # XY hops == manhattan distance
    else:  # KIND_SCOUT — route masks come from the scout at runtime
        dist[:rows] = mesh_dist

    if spec.kind in (KIND_BUS, KIND_PNSSD):
        mult = spec.bw_mult
        xfer_num, xfer_den = 1000, int(round(cfg.chan_gbps * mult * 1000))
        hop_ns = 0
        cmd_base_ns = cfg.t_cmd * TICK_NS  # lowers back to exactly t_cmd ticks
        ovh = cfg.t_bus_ovh if spec.bus_ovh else 0
    else:
        xfer_num, xfer_den = 1, 1  # Eq. (1): 8-bit links at 1 GHz = 1 B/ns
        hop_ns = 1
        cmd_base_ns = 8  # 8-byte command packet
        ovh = 0

    return dict(
        is_scout=spec.kind == KIND_SCOUT,
        fc_nearest=spec.fc_nearest,
        ovh=np.int32(ovh),
        cmd_base_ns=np.int32(cmd_base_ns),
        xfer_num=np.int32(xfer_num),
        xfer_den=np.int32(xfer_den),
        hop_ns=np.int32(hop_ns),
        allow_nonmin=spec.allow_nonminimal,
        hold=spec.hold_during_op,
        n_scouts=np.int32(spec.n_scouts),
        d_est_hops=np.int32(spec.d_est_hops),
        d_est_pad=np.int32(spec.d_est_pad),
        count_bus=spec.counts_bus_energy,
        cmask=cmask,
        hops=hops,
        cand2_ok=cand2_ok,
        fc_fixed=fc_fixed,
        dist=dist,
        fc_valid=fc_valid,
        fc_node=fc_node,
        res_dead=np.zeros((R,), dtype=bool),
    )


@functools.lru_cache(maxsize=None)
def lower_designs(cfg: SSDConfig, names: tuple) -> LaneTables:
    """Lower ``names`` (design names, in order) into stacked LaneTables."""
    resolve_specs(names)
    topo = build_mesh(cfg.rows, cfg.cols)
    lay = sweep_layout(cfg)
    lowered = [_lower_one(cfg, topo, lay, REGISTRY[d]) for d in names]
    return LaneTables(**{
        k: np.stack([low[k] for low in lowered]) for k in lowered[0]
    })


def resolve_specs(designs: Sequence[str]) -> tuple:
    """Validate design names and return their specs (same order)."""
    try:
        return tuple(REGISTRY[d] for d in designs)
    except KeyError as e:
        raise ValueError(f"unknown design {e.args[0]!r}; one of {DESIGNS}")
