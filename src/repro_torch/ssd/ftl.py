"""Flash Translation Layer (§2.2): L2P mapping, out-of-place writes, GC,
wear-leveling — and the decomposition of host I/O requests into the page-level
transactions consumed by the simulator.

This module is the **scalar oracle**: one page per Python iteration, written
for obviousness, it defines the FTL's semantics.  The production path is the
array-native engine in ``repro_torch.ssd.ftl_engine`` (``decompose_trace``'s
default for preconditioned traces), which is bit-identical by construction
and by test (``tests/test_torch_host.py``); this module stays the parity reference
and still owns GC/victim selection, which the engine calls into at trigger
points.

The FTL runs *ahead of* the timing simulation (numpy, sequential): physical
placement uses static channel-first striping (CWDP order), which is standard
practice and — per the paper §7 — no allocation policy can lay data out to
avoid path conflicts under random access + multi-tenant interference, so
placement is identical across all simulated designs (fair comparison).

GC valid-page moves use in-plane copyback (read + program on the same plane,
no channel/network transfer — commodity NAND supports copyback), plus the
block erase.  GC transactions are injected at the arrival time of the write
that triggered collection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.ssd.config import SSDConfig, us_to_ticks

KIND_READ, KIND_WRITE, KIND_ERASE = 0, 1, 2


class Transactions(dict):
    """dict of numpy arrays: arrival(ticks), kind, plane, node, row, nbytes, req.

    Carries side metadata as attributes (``ftl``, ``n_requests``, and — for
    multi-tenant traces — ``tenant_of_req``/``tenant_names``, the
    per-request tenant attribution threaded through to
    :class:`repro_torch.ssd.sim.SimResult`).  Attribution is pure metadata: it
    never reaches the scan, so tagged and untagged decompositions of the
    same trace simulate bit-identically.
    """


def stripe_plane(cfg: SSDConfig, idx):
    """Chunked W-C-D-P striping: plane for allocation index ``idx``.

    Works elementwise on ints and numpy arrays — the single source of
    truth for both the scalar FTL and the array-native engine.
    Consecutive allocations fill one plane for ``cfg.chunk_pages`` pages
    (superpage allocation), then stripe *way (chip) first within the
    channel*, then across channels.  Die-first fill is the standard
    write-path layout — it pipelines a sequential write's bus transfers on
    one channel while neighbours' tPROGs overlap.  The flip side (the
    paper's motivation): sequentially-written / hot data ranges end up on
    many chips of ONE channel, so reading them back serializes on that
    channel in the shared-bus baseline while a path-diverse interconnect
    can reach all its chips concurrently."""
    idx = idx // max(1, cfg.chunk_pages)
    way = idx % cfg.cols
    idx = idx // cfg.cols
    ch = idx % cfg.rows
    idx = idx // cfg.rows
    die = idx % cfg.dies_per_chip
    idx = idx // cfg.dies_per_chip
    pl = idx % cfg.planes_per_die
    chip = ch * cfg.cols + way
    return (chip * cfg.dies_per_chip + die) * cfg.planes_per_die + pl


@dataclasses.dataclass
class FTL:
    """Page-mapping FTL over a footprint-scaled physical geometry."""

    cfg: SSDConfig
    n_lpns: int
    overprovision: float = 1.28
    gc_threshold: int = 2

    def __post_init__(self) -> None:
        cfg = self.cfg
        self.n_planes = cfg.n_planes
        phys_pages = int(self.n_lpns * self.overprovision)
        self.pages_per_block = cfg.pages_per_block
        bpp = -(-phys_pages // (self.n_planes * self.pages_per_block))
        self.blocks_per_plane = max(bpp, self.gc_threshold + 2)
        self.pages_per_plane = self.blocks_per_plane * self.pages_per_block

        self.l2p = np.full((self.n_lpns,), -1, dtype=np.int64)
        self.p2l = np.full((self.n_planes * self.pages_per_plane,), -1, dtype=np.int64)
        self.valid = np.zeros((self.n_planes, self.blocks_per_plane), dtype=np.int32)
        self.written = np.zeros((self.n_planes, self.blocks_per_plane), dtype=np.int32)
        self.erase_count = np.zeros((self.n_planes, self.blocks_per_plane), dtype=np.int64)
        # free-block stacks (wear-aware: pop the least-erased free block)
        self.is_free = np.ones((self.n_planes, self.blocks_per_plane), dtype=bool)
        self.open_block = np.zeros((self.n_planes,), dtype=np.int64)
        for p in range(self.n_planes):
            self.is_free[p, 0] = False  # block 0 starts open
        self.next_page = np.zeros((self.n_planes,), dtype=np.int64)
        self._stripe = 0  # global plane round-robin pointer
        self.gc_events = 0
        self.gc_page_moves = 0
        # read-before-write preconditioning (DESIGN.md §3): pages mapped on
        # demand by reads, and the GC transactions that mapping triggered —
        # those transactions are *dropped* from the stream (the read is
        # served as if the page were already resident), so we count them.
        self.read_precond_pages = 0
        self.read_precond_gc_txns = 0

    # --- geometry helpers -------------------------------------------------
    def plane_of_ppn(self, ppn: int) -> int:
        return int(ppn // self.pages_per_plane)

    def chip_of_plane(self, plane: int) -> int:
        cfg = self.cfg
        return plane // (cfg.dies_per_chip * cfg.planes_per_die)

    # --- allocation -------------------------------------------------------
    def _alloc_in_plane(
        self, plane: int, out: list | None, t: int, during_gc: bool = False
    ) -> int:
        """Allocate the next free page in ``plane``'s open block (GC as needed)."""
        if self.next_page[plane] >= self.pages_per_block:
            self._open_new_block(plane, out, t, during_gc)
        block = self.open_block[plane]
        off = self.next_page[plane]
        self.next_page[plane] += 1
        self.written[plane, block] += 1
        ppn = plane * self.pages_per_plane + block * self.pages_per_block + off
        return int(ppn)

    def _open_new_block(
        self, plane: int, out: list | None, t: int, during_gc: bool = False
    ) -> None:
        # GC runs only for host allocations; GC's own copyback writes draw
        # from the gc_threshold blocks of reserved headroom (no reentrancy)
        if not during_gc:
            # steady-state GC: one victim per triggering allocation (classic
            # greedy foreground GC), plus an emergency loop that defends the
            # 2-block headroom copyback draws from
            if (
                np.count_nonzero(self.is_free[plane]) <= self.gc_threshold
                and self._has_victim(plane)
            ):
                self._collect(plane, out, t)
            guard = 0
            while np.count_nonzero(self.is_free[plane]) < 2:
                if not self._has_victim(plane) or guard > 8:  # pragma: no cover
                    raise RuntimeError("GC cannot reclaim space")
                self._collect(plane, out, t)
                guard += 1
            if self.next_page[plane] < self.pages_per_block:
                # GC's copyback writes re-opened a block with room left —
                # keep filling it instead of abandoning a partial block
                return
        free_ids = np.flatnonzero(self.is_free[plane])
        if len(free_ids) == 0:  # pragma: no cover
            raise RuntimeError(f"plane {plane} out of blocks during GC")
        # wear leveling: open the least-erased free block
        nxt = free_ids[np.argmin(self.erase_count[plane, free_ids])]
        self.is_free[plane, nxt] = False
        self.open_block[plane] = nxt
        self.next_page[plane] = 0

    def _victim_mask(self, plane: int) -> np.ndarray:
        full = (self.written[plane] >= self.pages_per_block) & ~self.is_free[plane]
        full[self.open_block[plane]] = False
        return full

    def _has_victim(self, plane: int) -> bool:
        return bool(self._victim_mask(plane).any())

    def _collect(self, plane: int, out: list | None, t: int) -> None:
        """Greedy GC: victim = fully-written block with fewest valid pages."""
        cand = np.flatnonzero(self._victim_mask(plane))
        if len(cand) == 0:
            raise RuntimeError(
                f"plane {plane} has no GC victim — overprovision too small"
            )
        victim = cand[np.argmin(self.valid[plane, cand])]
        self.gc_events += 1
        base = plane * self.pages_per_plane + victim * self.pages_per_block
        for off in range(self.pages_per_block):
            lpn = self.p2l[base + off]
            if lpn < 0:
                continue
            # copyback: read + program in-plane, no network transfer
            self.gc_page_moves += 1
            new_ppn = self._alloc_in_plane(plane, out, t, during_gc=True)
            self.l2p[lpn] = new_ppn
            self.p2l[new_ppn] = lpn
            self.p2l[base + off] = -1
            self.valid[plane, victim] -= 1
            blk = new_ppn // self.pages_per_block % self.blocks_per_plane
            self.valid[plane, blk] += 1
            if out is not None:
                out.append((t, KIND_READ, plane, 0, -1))
                out.append((t, KIND_WRITE, plane, 0, -1))
        self.valid[plane, victim] = 0
        self.written[plane, victim] = 0
        self.is_free[plane, victim] = True
        self.erase_count[plane, victim] += 1
        if out is not None:
            out.append((t, KIND_ERASE, plane, 0, -1))

    def _stripe_plane(self, idx: int) -> int:
        """Chunked W-C-D-P striping (see module-level ``stripe_plane``)."""
        return int(stripe_plane(self.cfg, idx))

    # --- host ops ----------------------------------------------------------
    def write_page(self, lpn: int, out: list | None, t: int) -> int:
        old = self.l2p[lpn]
        if old >= 0:  # out-of-place: invalidate the overwritten physical page
            pl = self.plane_of_ppn(old)
            blk = (old % self.pages_per_plane) // self.pages_per_block
            self.valid[pl, blk] -= 1
            self.p2l[old] = -1
        plane = self._stripe_plane(self._stripe)  # CWDP page striping
        self._stripe += 1
        ppn = self._alloc_in_plane(plane, out, t)
        self.l2p[lpn] = ppn
        self.p2l[ppn] = lpn
        blk = (ppn % self.pages_per_plane) // self.pages_per_block
        self.valid[plane, blk] += 1
        return ppn

    def read_page(self, lpn: int) -> int:
        ppn = self.l2p[lpn]
        if ppn < 0:  # read-before-write: precondition instantly
            # The mapping write (and any GC it triggers) mutates FTL state
            # but emits no transactions — the read is modeled as hitting
            # already-resident data.  Count the dropped work (DESIGN.md §3).
            dropped: list = []
            self.read_precond_pages += 1
            ppn = self.write_page(lpn, dropped, 0)
            self.read_precond_gc_txns += len(dropped)
        return int(ppn)


def to_transactions(
    cfg: SSDConfig, arr: np.ndarray, ftl: FTL, n_requests: int
) -> Transactions:
    """Insertion-ordered (tick, kind, plane, nbytes, req) rows → Transactions.

    Shared tail of both decomposition engines: the *stable* sort by arrival
    tick is what makes "same rows in the same insertion order" imply
    bit-identical output arrays.
    """
    if arr.size == 0:
        arr = np.zeros((0, 5), dtype=np.int64)
    if arr.size and int(arr[:, 0].max()) > np.iinfo(np.int32).max:
        raise ValueError(
            "transaction arrival ticks exceed the int32 budget — slice the "
            "trace into windows of at most ~21 s of arrivals"
        )
    order = np.argsort(arr[:, 0], kind="stable")
    arr = arr[order]
    plane = arr[:, 2]
    chip = plane // (cfg.dies_per_chip * cfg.planes_per_die)
    txns = Transactions(
        arrival=arr[:, 0].astype(np.int32),
        kind=arr[:, 1].astype(np.int32),
        plane=plane.astype(np.int32),
        node=chip.astype(np.int32),
        row=(chip // cfg.cols).astype(np.int32),
        nbytes=arr[:, 3].astype(np.int32),
        req=arr[:, 4].astype(np.int32),
    )
    txns.ftl = ftl  # expose for tests / stats
    txns.n_requests = n_requests
    # read-before-write preconditioning work (dropped from the stream but
    # counted — DESIGN.md §3); zero whenever ``precondition=True``
    txns.read_precond_pages = ftl.read_precond_pages
    txns.read_precond_gc_txns = ftl.read_precond_gc_txns
    return txns


def decompose_trace(
    cfg: SSDConfig,
    trace: Dict[str, np.ndarray],
    footprint_pages: int,
    overprovision: float = 1.28,
    precondition: bool = True,
    engine: str = "auto",
) -> Transactions:
    """Host trace → page-level transaction arrays for ``repro_torch.ssd.sim``.

    ``trace``: arrival_us (f64), is_read (bool), offset_page (int64, in cfg
    pages), n_pages (int).  Offsets are taken modulo ``footprint_pages``.

    ``engine``: ``"vector"`` runs the array-native engine
    (``repro_torch.ssd.ftl_engine``, bit-identical by construction and by test),
    ``"scalar"`` forces this module's page-at-a-time oracle, ``"auto"``
    picks vector whenever it applies (preconditioned traces — the vector
    read path is a pure L2P gather, which requires every read to hit a
    mapped page).
    """
    if engine not in ("auto", "vector", "scalar"):
        raise ValueError(f"unknown FTL engine {engine!r}")
    if engine == "vector" and not precondition:
        raise ValueError(
            "vector FTL engine requires precondition=True "
            "(reads lower to pure L2P gathers)"
        )
    if engine != "scalar" and precondition:
        from repro_torch.ssd.ftl_engine import decompose_vectorized

        return _attach_tenants(decompose_vectorized(
            cfg, trace, footprint_pages, overprovision=overprovision), trace)
    ftl = FTL(cfg, n_lpns=footprint_pages, overprovision=overprovision)
    if precondition:
        # map the whole footprint so reads always hit a valid physical
        # page.  Sequential LPN order preserves spatial locality:
        # consecutive LBAs share a chunk/chip and nearby chunks share a
        # channel (W-C-D-P), as they would after a real sequential fill.
        for lpn in range(footprint_pages):
            ftl.write_page(lpn, None, 0)

    arrival = trace["arrival_us"]
    is_read = trace["is_read"]
    offset = trace["offset_page"]
    n_pages = trace["n_pages"]
    rows = []  # (ticks, kind, plane, nbytes, req)
    for i in range(len(arrival)):
        t = us_to_ticks(float(arrival[i]))
        base = int(offset[i])
        for k in range(int(n_pages[i])):
            lpn = (base + k) % footprint_pages
            if is_read[i]:
                ppn = ftl.read_page(lpn)
                plane = ftl.plane_of_ppn(ppn)
                rows.append((t, KIND_READ, plane, cfg.page_bytes, i))
            else:
                gc_out: list = []
                ftl.write_page(lpn, gc_out, t)
                # the host write itself
                plane = ftl.plane_of_ppn(ftl.l2p[lpn])
                rows.append((t, KIND_WRITE, plane, cfg.page_bytes, i))
                # GC work occupies resources but is background traffic: it is
                # not part of the triggering request's host-visible latency
                for (tg, kind, pl, nb, _r) in gc_out:
                    rows.append((tg, kind, pl, nb, -1))

    arr = np.asarray(rows, dtype=np.int64)
    return _attach_tenants(
        to_transactions(cfg, arr, ftl, int(len(arrival))), trace
    )


def _attach_tenants(txns: Transactions, trace: Dict) -> Transactions:
    """Thread per-request tenant attribution (if the trace carries any)."""
    tenant = trace.get("tenant")
    if tenant is not None:
        txns.tenant_of_req = np.asarray(tenant, np.int32)
        txns.tenant_names = tuple(trace.get(
            "tenant_names",
            [str(t) for t in range(int(txns.tenant_of_req.max()) + 1)],
        ))
    return txns
