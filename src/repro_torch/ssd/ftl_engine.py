"""Array-native FTL engine: vectorized trace → transaction decomposition.

Produces **bit-identical** ``Transactions`` to the scalar page-at-a-time FTL
in ``repro_torch.ssd.ftl`` (retained as the parity oracle; ``tests/test_torch_host.py``
asserts array-for-array and state-for-state equality, including GC-heavy
geometries).  The scalar oracle walks one page per Python iteration —
32k ``write_page`` calls just to precondition a 128 MB footprint — while
this engine exploits the determinism of the FTL's policies:

* **Preconditioning is closed-form.**  The sequential footprint fill uses
  W-C-D-P striping, which is pure arithmetic on the stripe index, and with
  all-zero erase counts the wear-aware allocator opens blocks 0,1,2,… in
  order — so the entire initial L2P/P2L map, per-block accounting and
  per-plane cursors are one numpy pass.  (If the geometry is so tight that
  the fill itself would trigger GC, we fall back to the scalar loop: GC
  ordering is the oracle's to define.)
* **Request → page expansion is ``repeat``/``cumsum``.**  No per-request
  inner loop; LPNs, arrival ticks and request ids for every page-op come
  from one broadcast.
* **Reads lower to a pure L2P gather.**  With a preconditioned footprint a
  read never mutates FTL state, so its physical page is "the last write to
  this LPN earlier in the stream, else the preconditioned mapping" — a
  grouped forward-fill over (lpn, position), not a replay.
* **Writes are epoch-vectorized.**  Between GC triggers every allocation is
  closed-form given the per-plane cursors: pages fill the open block then
  free blocks in wear order (erase counts cannot change mid-epoch).  The
  engine computes, per plane, how many pages fit before the *next* risky
  block-open (one that finds free blocks ≤ ``gc_threshold``), allocates
  that run in one shot, and hands exactly the triggering write to the
  scalar FTL's ``write_page`` — GC, victim selection and copyback stay the
  oracle's code, byte for byte.  GC is rare, so epochs are long.

The emitted rows are assembled in the oracle's insertion order (host row,
then that write's GC rows) before the shared stable sort-by-arrival, which
is what makes bit-identity a construction rather than a coincidence.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.ssd.config import SSDConfig, TICK_NS
from repro_torch.ssd.ftl import (
    FTL,
    KIND_READ,
    KIND_WRITE,
    Transactions,
    stripe_plane,
    to_transactions,
)


def _cumcount(x: np.ndarray) -> np.ndarray:
    """Rank of each element among earlier equal elements (grouped 0,1,2,…)."""
    n = x.size
    order = np.argsort(x, kind="stable")
    xs = x[order]
    starts = np.flatnonzero(np.concatenate(([True], xs[1:] != xs[:-1])))
    lens = np.diff(np.concatenate((starts, [n])))
    rank_sorted = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
    out = np.empty(n, dtype=np.int64)
    out[order] = rank_sorted
    return out


def _precondition_vectorized(ftl: FTL) -> bool:
    """One-pass sequential footprint fill; False if the fill would GC."""
    F = ftl.n_lpns
    if F == 0:
        return True
    cfg = ftl.cfg
    ppb = ftl.pages_per_block
    planes = stripe_plane(cfg, np.arange(F, dtype=np.int64))
    counts = np.bincount(planes, minlength=ftl.n_planes)
    # k-th block-open in a plane sees ``blocks_per_plane - k`` free blocks;
    # a fill needing an open the oracle would GC at — its steady trigger
    # (free ≤ gc_threshold) or its emergency headroom guard (free < 2),
    # folded via max() like the epoch loop — is rare (footprint ≈ whole
    # device) and handled by fallback.
    opens = np.maximum(0, -(-counts // ppb) - 1)
    if np.any(ftl.blocks_per_plane - opens <= max(ftl.gc_threshold, 1)):
        return False
    rank = _cumcount(planes)
    ppn = planes * ftl.pages_per_plane + rank  # blocks open 0,1,2,… in order
    ftl.l2p[:] = ppn
    ftl.p2l[ppn] = np.arange(F, dtype=np.int64)
    per_blk = np.bincount(
        planes * ftl.blocks_per_plane + rank // ppb,
        minlength=ftl.n_planes * ftl.blocks_per_plane,
    ).reshape(ftl.n_planes, ftl.blocks_per_plane)
    ftl.written[:] = per_blk
    ftl.valid[:] = per_blk
    open_blk = np.maximum(counts - 1, 0) // ppb  # lazy-open: stays on the
    ftl.open_block[:] = open_blk  # last filled block even when it is full
    ftl.next_page[:] = counts - open_blk * ppb
    ftl.is_free[:] = (
        np.arange(ftl.blocks_per_plane)[None, :] > open_blk[:, None]
    )
    ftl._stripe = F
    return True


def _alloc_epoch(
    ftl: FTL, planes: np.ndarray, lpns: np.ndarray, rank: np.ndarray
) -> np.ndarray:
    """Allocate one GC-free run of host writes (in stream order) in one pass.

    ``rank`` is each write's per-plane rank *within this run* (the caller
    derives it from the stream-global cumcount, so no re-sort here).  The
    caller guarantees no allocation in this run opens a block at
    free ≤ gc_threshold, so block opens are pure pops of the wear-ordered
    free list and no state consulted here (erase counts, victim masks) can
    change mid-run.  Mirrors exactly what ``write_page`` would have done.
    """
    ppb = ftl.pages_per_block
    P, B = ftl.n_planes, ftl.blocks_per_plane
    n = planes.size
    slot = ftl.next_page[planes] + rank  # virtual slot past the open cursor
    counts = np.bincount(planes, minlength=P)
    end = ftl.next_page + counts
    n_open = np.maximum(0, -(-(end - ppb) // ppb))  # opens this run needs
    max_open = int(n_open.max()) if n else 0
    in_open = slot < ppb
    blk = np.where(in_open, ftl.open_block[planes], 0)
    off = np.where(in_open, slot, 0)
    if max_open > 0:
        # wear order = (erase_count, block id): popping the argmin free
        # block k times equals taking the first k of this lexsort
        free_tab = np.zeros((P, max_open), dtype=np.int64)
        for p in np.flatnonzero(n_open > 0):
            ids = np.flatnonzero(ftl.is_free[p])
            take = ids[np.lexsort((ids, ftl.erase_count[p, ids]))][: n_open[p]]
            free_tab[p, : take.size] = take
            ftl.is_free[p, take] = False
        over = slot - ppb
        fi = np.where(in_open, 0, over // ppb)
        blk = np.where(in_open, blk, free_tab[planes, fi])
        off = np.where(in_open, off, over % ppb)
        opened = n_open > 0
        ftl.open_block[opened] = free_tab[opened, n_open[opened] - 1]
    ppn = planes * ftl.pages_per_plane + blk * ppb + off
    ftl.next_page[:] = np.where(counts > 0, end - n_open * ppb, ftl.next_page)

    inc = np.bincount(planes * B + blk, minlength=P * B).reshape(P, B)
    ftl.written += inc
    ftl.valid += inc
    # out-of-place invalidation: the page each write supersedes is the
    # previous write to the same LPN in this run, else the pre-run mapping
    order = np.argsort(lpns, kind="stable")
    l_s, p_s = lpns[order], ppn[order]
    old_s = ftl.l2p[l_s]
    same = l_s[1:] == l_s[:-1]
    old_s[1:][same] = p_s[:-1][same]
    old = old_s[old_s >= 0]
    if old.size:
        dec = np.bincount(
            (old // ftl.pages_per_plane) * B
            + (old % ftl.pages_per_plane) // ppb,
            minlength=P * B,
        ).reshape(P, B)
        ftl.valid -= dec
    ftl.p2l[ppn] = lpns
    if old.size:
        ftl.p2l[old] = -1  # intra-run supersessions land after their set
    ftl.l2p[lpns] = ppn  # duplicate LPNs: numpy keeps the last write
    return ppn


def decompose_vectorized(
    cfg: SSDConfig,
    trace: Dict[str, np.ndarray],
    footprint_pages: int,
    overprovision: float = 1.28,
) -> Transactions:
    """Vectorized ``decompose_trace`` (preconditioned traces only)."""
    ftl = FTL(cfg, n_lpns=footprint_pages, overprovision=overprovision)
    if not _precondition_vectorized(ftl):
        for lpn in range(footprint_pages):  # tight geometry: oracle's GC
            ftl.write_page(lpn, None, 0)
    l2p0 = ftl.l2p.copy()  # mapping reads see when no stream write precedes

    arrival = np.asarray(trace["arrival_us"], dtype=np.float64)
    is_read = np.asarray(trace["is_read"], dtype=bool)
    offset = np.asarray(trace["offset_page"], dtype=np.int64)
    n_pg = np.asarray(trace["n_pages"], dtype=np.int64)
    n_req = int(len(arrival))
    # same float64 op sequence as us_to_ticks: (us * 1e3) / TICK_NS, ceil
    t_req = np.ceil(arrival * 1e3 / TICK_NS).astype(np.int64)

    # request → page-op expansion (repeat/cumsum, no inner loop)
    T = int(n_pg.sum()) if n_req else 0
    req_of = np.repeat(np.arange(n_req, dtype=np.int64), n_pg)
    starts = np.cumsum(n_pg) - n_pg
    k = np.arange(T, dtype=np.int64) - np.repeat(starts, n_pg)
    lpn = (offset[req_of] + k) % footprint_pages
    t_op = t_req[req_of]
    rd = is_read[req_of]

    # ---- write path: epoch-vectorized, scalar only at GC triggers --------
    w_pos = np.flatnonzero(~rd)
    W = w_pos.size
    w_lpn = lpn[w_pos]
    w_t = t_op[w_pos]
    w_plane = stripe_plane(cfg, ftl._stripe + np.arange(W, dtype=np.int64))
    # stream-global per-plane rank, computed ONCE: each epoch's local rank
    # is this minus the count of writes that plane has already consumed, so
    # GC-heavy traces don't re-sort the whole remaining suffix per trigger
    w_rank = _cumcount(w_plane)
    consumed = np.zeros(ftl.n_planes, dtype=np.int64)
    w_ppn = np.empty(W, dtype=np.int64)
    gc_chunks: list = []  # (host op position, oracle's gc_out rows)
    at = 0
    while at < W:
        free_cnt = ftl.is_free.sum(axis=1)
        # pages each plane absorbs before a *risky* open — one the oracle
        # would GC at: its steady-state trigger (free ≤ gc_threshold) or its
        # emergency headroom guard (free < 2, hardcoded in _open_new_block);
        # max() folds both so a lowered gc_threshold can't skip the guard.
        # Cap = the open block's tail plus every safe open's full block.
        risk_free = max(ftl.gc_threshold, 1)
        cap = (ftl.pages_per_block - ftl.next_page) + np.maximum(
            0, free_cnt - risk_free
        ) * ftl.pages_per_block
        suffix = w_plane[at:]
        risky = w_rank[at:] >= (cap + consumed)[suffix]
        j = int(np.argmax(risky)) if risky.any() else int(suffix.size)
        if j:
            sl = slice(at, at + j)
            w_ppn[sl] = _alloc_epoch(
                ftl, w_plane[sl], w_lpn[sl],
                w_rank[sl] - consumed[w_plane[sl]],
            )
            np.add.at(consumed, w_plane[sl], 1)
            ftl._stripe += j
            at += j
        if at < W:  # the triggering write runs the oracle (GC and all)
            out: list = []
            ftl.write_page(int(w_lpn[at]), out, int(w_t[at]))
            w_ppn[at] = int(ftl.l2p[w_lpn[at]])
            if out:
                gc_chunks.append((int(w_pos[at]), out))
            consumed[w_plane[at]] += 1
            at += 1

    # ---- read path: pure L2P gather (last stream write wins, else the
    # preconditioned mapping) — a grouped forward-fill over (lpn, pos) -----
    r_pos = np.flatnonzero(rd)
    R = r_pos.size
    if R:
        pos_all = np.concatenate((w_pos, r_pos))
        lpn_all = np.concatenate((w_lpn, lpn[r_pos]))
        val_all = np.concatenate((w_ppn, np.full(R, -1, dtype=np.int64)))
        is_wr = np.zeros(W + R, dtype=bool)
        is_wr[:W] = True
        order = np.lexsort((pos_all, lpn_all))
        lpn_s = lpn_all[order]
        val_s = val_all[order]
        wr_s = is_wr[order]
        idx = np.arange(W + R, dtype=np.int64)
        last_wr = np.maximum.accumulate(np.where(wr_s, idx, -1))
        lw = np.clip(last_wr, 0, None)
        hit = (last_wr >= 0) & (lpn_s[lw] == lpn_s)
        ppn_s = np.where(hit, val_s[lw], l2p0[lpn_s])
        inv = np.empty(W + R, dtype=np.int64)
        inv[order] = idx
        r_ppn = ppn_s[inv[W:]]
        if np.any(r_ppn < 0):  # precondition guarantees full coverage
            raise RuntimeError("read hit an unmapped LPN despite precondition")
    else:
        r_ppn = np.zeros(0, dtype=np.int64)

    # ---- assemble rows in the oracle's insertion order -------------------
    tick = np.empty(T, dtype=np.int64)
    kind = np.where(rd, KIND_READ, KIND_WRITE).astype(np.int64)
    plane_col = np.empty(T, dtype=np.int64)
    tick[:] = t_op
    plane_col[w_pos] = w_ppn // ftl.pages_per_plane
    plane_col[r_pos] = r_ppn // ftl.pages_per_plane
    nbytes = np.full(T, cfg.page_bytes, dtype=np.int64)
    req_col = req_of
    g_host = np.arange(T, dtype=np.int64)
    sub_host = np.zeros(T, dtype=np.int64)
    if gc_chunks:  # GC rows slot directly after their triggering host write
        g_gc = np.concatenate(
            [np.full(len(out), g, dtype=np.int64) for g, out in gc_chunks]
        )
        sub_gc = np.concatenate(
            [np.arange(1, len(out) + 1, dtype=np.int64) for _, out in gc_chunks]
        )
        flat = [row for _, out in gc_chunks for row in out]
        gc_arr = np.asarray(flat, dtype=np.int64)  # (t, kind, plane, 0, -1)
        tick = np.concatenate((tick, gc_arr[:, 0]))
        kind = np.concatenate((kind, gc_arr[:, 1]))
        plane_col = np.concatenate((plane_col, gc_arr[:, 2]))
        nbytes = np.concatenate((nbytes, gc_arr[:, 3]))
        req_col = np.concatenate((req_col, gc_arr[:, 4]))
        g_all = np.concatenate((g_host, g_gc))
        sub_all = np.concatenate((sub_host, sub_gc))
        ins = np.lexsort((sub_all, g_all))
    else:
        ins = g_host
    arr = np.stack((tick, kind, plane_col, nbytes, req_col), axis=1)[ins]
    return to_transactions(cfg, arr, ftl, n_req)
