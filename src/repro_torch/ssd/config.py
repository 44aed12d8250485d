"""SSD configurations (paper Table 1) and the power model (§6.4/§6.6).

All simulator time is integer *ticks* of 10 ns (``TICK_NS``): every latency in
Table 1 is a multiple of 10 ns, and integer ticks keep the lane scans exact
in int32 arithmetic on the card and on the CPU. int32 ticks span ±21 s.
"""
from __future__ import annotations

import dataclasses
import math

TICK_NS = 10  # one simulator tick = 10 ns


def ns_to_ticks(ns: float) -> int:
    return int(math.ceil(ns / TICK_NS))


def us_to_ticks(us: float) -> int:
    return ns_to_ticks(us * 1e3)


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Component powers. Paper-sourced where the paper gives numbers (§6.6:
    router 0.241 mW; link 1.08 mW during a transfer, 90% below the shared bus
    ⇒ bus ≈ 10.8 mW while driven). Flash-die/static powers are calibrated
    estimates (Z-SSD-class device; documented in DESIGN.md): average SSD power
    is dominated by the controller+DRAM static term, which is what makes the
    paper's ~61% energy saving track the ~62% execution-time saving."""

    static_w: float = 1.50  # controller + DRAM + interface, always on
    die_read_w: float = 0.012  # per plane during tR
    die_prog_w: float = 0.018  # per plane during tPROG
    die_erase_w: float = 0.020  # per plane during tBERS
    bus_active_w: float = 0.0108  # per shared channel while driven (§6.6)
    link_active_w: float = 0.00108  # per mesh link while reserved (§6.6)
    router_w: float = 0.000241  # per router, always on (§6.6)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    name: str
    # --- flash array geometry (Table 1) ---
    rows: int = 8  # flash controllers / channels
    cols: int = 8  # chips per channel (= mesh columns)
    dies_per_chip: int = 1
    planes_per_die: int = 2
    pages_per_block: int = 768
    page_bytes: int = 4096
    # --- latencies ---
    t_read_us: float = 3.0  # tR
    t_prog_us: float = 100.0  # tPROG
    t_erase_us: float = 1000.0  # tBERS
    cmd_ns: float = 10.0  # command transfer on a free path (§3.1)
    # --- interconnect ---
    chan_gbps: float = 1.2  # shared-channel I/O rate, GB/s (Table 1)
    link_ghz: float = 1.0  # Venice: 8-bit links at 1 GHz ⇒ 1 B/ns (Table 1)
    scout_flit_ns: float = 2.0  # 2 x 8-bit scout flits per hop at 1 GHz
    # Per-phase protocol overhead on the legacy (non-packetized) shared bus:
    # ONFI command/address/status cycles + arbitration.  Calibrated from the
    # paper's own §3.1 numbers: a 4KB transfer takes 4 us on the 1.2 GB/s
    # channel (4096 B / 1.2 GB/s = 3.41 us) => ~0.59 us protocol overhead.
    # Paid by baseline and the ideal SSD (same channel protocol, just private);
    # NOT paid by pSSD/pnSSD (packetized [15]) or the mesh designs.
    bus_protocol_ovh_ns: float = 590.0
    # FTL stripe chunk (pages): consecutive LBAs fill one plane for a chunk
    # before striping on (superpage allocation, industry standard); this is
    # what makes sequential bursts channel-skewed — the paper's conflicts.
    chunk_pages: int = 8
    power: PowerModel = dataclasses.field(default_factory=PowerModel)

    # ---- derived ----
    @property
    def n_chips(self) -> int:
        return self.rows * self.cols

    @property
    def n_planes(self) -> int:
        return self.n_chips * self.dies_per_chip * self.planes_per_die

    @property
    def t_read(self) -> int:
        return us_to_ticks(self.t_read_us)

    @property
    def t_prog(self) -> int:
        return us_to_ticks(self.t_prog_us)

    @property
    def t_erase(self) -> int:
        return us_to_ticks(self.t_erase_us)

    @property
    def t_cmd(self) -> int:
        return max(1, ns_to_ticks(self.cmd_ns))

    @property
    def t_bus_ovh(self) -> int:
        return ns_to_ticks(self.bus_protocol_ovh_ns)


def perf_optimized(**over) -> SSDConfig:
    """Samsung Z-NAND-based performance-optimized config (Table 1)."""
    kw = dict(
        name="perf",
        page_bytes=4096,
        pages_per_block=768,
        t_read_us=3.0,
        t_prog_us=100.0,
        t_erase_us=1000.0,
    )
    kw.update(over)
    return SSDConfig(**kw)


def cost_optimized(**over) -> SSDConfig:
    """Samsung PM9A3-based cost-optimized config (Table 1): 3D TLC."""
    kw = dict(
        name="cost",
        page_bytes=16384,
        pages_per_block=768,
        t_read_us=45.0,
        t_prog_us=650.0,
        t_erase_us=3500.0,
    )
    kw.update(over)
    return SSDConfig(**kw)
