"""Plain PyTorch versions of the lane-scan kernels.

Each function here computes exactly what its CUDA kernel computes, written
the straightforward way: vectorised over lanes, a Python loop over the
transactions of the scan, dense masks over the unified resource vector
where the kernel walks sparse index lists.  They serve two roles:

* the CPU path — a wrapper in ``static_scan.py`` / ``scout.py`` runs them
  when (and only when) its tensors lie on the CPU;
* the yardstick of correctness — ``chip_smoke.py`` holds every kernel
  against them on the card, element by element.

Integer conventions follow the JAX reference exactly: ticks are int32 with
floor division; the scout rng is a uint32 carried here as int64 masked to
32 bits (PyTorch on the CPU has no uint32 shifts and only arithmetic int32
right shifts), so xorshift32, the unsigned modulo and the per-reservation
LCG are all exact.

Layouts shared with the kernels:

``lanes``   int32 [B, 4] — (table index, first transaction, length, first
            output slot) per lane; lanes of one run share transactions.
``txns``    int32 [6, T] — arrival, kind, plane, node, nbytes, op_ticks.
``out``     int32 [10, n_out] — the ``StepOut`` fields in order
            (completion, wait, conflict, hops, tries, scout_steps,
            misroutes, bus_hold, link_hold, failed), bools as 0/1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rng import LCG_ADD, LCG_MUL, MASK32

BIG = 2**30
FAIL_TIMEOUT = 1 << 20
MAX_TRIES = 64
TICK_NS = 10
KIND_READ = 0
N_OUT = 10

# column order of the per-table scalar block of each cost class
STATIC_SCALARS = ("fc_nearest", "count_bus", "hold", "ovh", "cmd_base_ns",
                  "xfer_num", "xfer_den", "hop_ns", "d_est_hops", "d_est_pad")
SCOUT_SCALARS = ("allow_nonmin", "hold", "d_est_hops", "d_est_pad",
                 "cmd_base_ns", "xfer_num", "xfer_den", "hop_ns")


class StaticTables(NamedTuple):
    """Design tables of the statically-routed lanes, stacked over ``T``."""

    scal: torch.Tensor  # int32 [T, len(STATIC_SCALARS)]
    cmask: torch.Tensor  # bool [T, F_pad, N, 2, R_pad]
    hops: torch.Tensor  # int32 [T, F_pad, N, 2]
    cand2: torch.Tensor  # bool [T, N]
    fc_fixed: torch.Tensor  # int32 [T, N, 2]
    dist: torch.Tensor  # int32 [T, F_pad, N]
    fc_valid: torch.Tensor  # bool [T, F_pad]
    res_dead: torch.Tensor  # bool [T, R_pad]


class ScoutTables(NamedTuple):
    """Design tables of the scout-routed lanes, stacked over ``T``."""

    scal: torch.Tensor  # int32 [T, len(SCOUT_SCALARS)]
    dist: torch.Tensor  # int32 [T, F_pad, N]
    fc_valid: torch.Tensor  # bool [T, F_pad]
    fc_node: torch.Tensor  # int32 [T, F_pad]
    res_dead: torch.Tensor  # bool [T, R_pad] (the link section is used)


class MeshTables(NamedTuple):
    """The mesh's port tables and the scout's per-hop round-trip cost."""

    port_link: torch.Tensor  # int32 [N, 4], -1 off mesh
    port_neighbor: torch.Tensor  # int32 [N, 4], -1 off mesh
    cols: int
    scout_hop_ns: int


# ---------------------------------------------------------------------------
# single-gap resource primitives (elementwise; see the JAX reference
# ``repro.ssd.sim._gap_avail``/``_gap_commit``/``_busy_at``)
# ---------------------------------------------------------------------------


def gap_avail(gs, ge, fa, e, d):
    """Earliest start >= e where a d-tick usage fits (gap or tail)."""
    s_gap = torch.maximum(e, gs)
    return torch.where(s_gap + d <= ge, s_gap, torch.maximum(e, fa))


def gap_commit(gs, ge, fa, s, e2):
    """Carve [s, e2) out; remember the larger leftover gap."""
    in_gap = (s >= gs) & (e2 <= ge)
    left_bigger = (s - gs) >= (ge - e2)
    g_gs = torch.where(left_bigger, gs, e2)
    g_ge = torch.where(left_bigger, s, ge)
    sfa = torch.maximum(s, fa)
    keep_old = (ge - gs) >= (sfa - fa)
    a_gs = torch.where(keep_old, gs, fa)
    a_ge = torch.where(keep_old, ge, sfa)
    a_fa = torch.maximum(fa, e2)
    return (torch.where(in_gap, g_gs, a_gs), torch.where(in_gap, g_ge, a_ge),
            torch.where(in_gap, fa, a_fa))


def busy_at(fa, gs, ge, t, d):
    """True where a resource cannot host a d-tick usage starting at t."""
    return ~((t >= fa) | ((t >= gs) & (t + d <= ge)))


def commit_mask(res, mask, s, e2):
    """Commit [s, e2) on every masked resource of ``res`` [B, 3, R]."""
    fa, gs, ge = res[:, 0], res[:, 1], res[:, 2]
    ngs, nge, nfa = gap_commit(gs, ge, fa, s[:, None], e2[:, None])
    return torch.stack((torch.where(mask, nfa, fa), torch.where(mask, ngs, gs),
                        torch.where(mask, nge, ge)), dim=1)


def _ceil_div(a, b):
    return (a + b - 1) // b


def _cmd_ticks(sc, hops):
    ns = sc["cmd_base_ns"] + hops * sc["hop_ns"]
    return torch.clamp(_ceil_div(ns, TICK_NS), min=1)


def _xfer_ticks(sc, nbytes, hops):
    ns = _ceil_div(nbytes * sc["xfer_num"], sc["xfer_den"]) + hops * sc["hop_ns"]
    return _ceil_div(ns, TICK_NS)


def _fc_select(avail, dist_row, tcand):
    """Closest FC free now, else earliest available (first occurrence)."""
    free_now = avail <= tcand[:, None]
    any_free = free_now.any(dim=1)
    by_dist = torch.argmin(torch.where(free_now, dist_row, BIG), dim=1)
    by_time = torch.argmin(avail, dim=1)
    fc = torch.where(any_free, by_dist, by_time)
    t0 = torch.maximum(tcand, avail.gather(1, fc[:, None])[:, 0])
    return fc, t0


def _lane_inputs(lanes, txns, i):
    """Active mask and this step's transaction fields for every lane."""
    active = lanes[:, 2] > i
    return active, txns[:, torch.where(active, lanes[:, 1] + i, 0).long()]


def _write_out(out, lanes, i, active, fields):
    slots = (lanes[:, 3] + i).long()[active]
    for k, v in enumerate(fields):
        out[k, slots] = v.to(torch.int32)[active]


# ---------------------------------------------------------------------------
# B1: statically-routed lane scan
# ---------------------------------------------------------------------------


def _path_sched(res, mask, e, d):
    """Earliest common start >= e of a d-tick usage of every masked
    resource; falls back to the masked free-at tail when the joint
    gap candidate does not fit everywhere."""
    fa, gs, ge = res[:, 0], res[:, 1], res[:, 2]
    avail = gap_avail(gs, ge, fa, e[:, None], d[:, None])
    s1 = torch.where(mask, avail, 0).amax(dim=1)
    s1 = torch.maximum(s1, e)
    ok = ~(busy_at(fa, gs, ge, s1[:, None], d[:, None]) & mask).any(dim=1)
    s_tail = torch.maximum(e, torch.where(mask, fa, 0).amax(dim=1))
    return torch.where(ok, s1, s_tail)


def _eval_static_cand(tab, sc, res, tx, is_read, t0, fc, cand, enable):
    """One candidate path: phase 0 (command, + data for writes), the flash
    op, phase 1 (read data) on one combined mask."""
    node, nbytes, op = tx[3].long(), tx[4], tx[5]
    mask = tab.cmask[sc["t"], fc, node, cand]
    dead = (mask & tab.res_dead[sc["t"]]).any(dim=1)
    enable = enable & ~dead
    hops = tab.hops[sc["t"], fc, node, cand]
    cmd = _cmd_ticks(sc, hops)
    xfer = _xfer_ticks(sc, nbytes, hops)
    ovh = sc["ovh"]
    d0 = ovh + cmd + torch.where(is_read, 0, xfer)
    s0 = _path_sched(res, mask, t0, d0)
    res = torch.where(enable[:, None, None],
                      commit_mask(res, mask, s0, s0 + d0), res)
    op_end = s0 + d0 + op
    d1 = ovh + xfer
    s1 = _path_sched(res, mask, op_end, d1)
    res = torch.where((enable & is_read)[:, None, None],
                      commit_mask(res, mask, s1, s1 + d1), res)
    done = torch.where(is_read, s1 + d1, op_end)
    wait = (s0 - t0) + torch.where(is_read, s1 - op_end, 0)
    occ = d0 + torch.where(is_read, d1, 0)
    return res, done, wait, occ, hops, dead


def static_lane_scan_ref(tables: StaticTables, lanes, txns, plane_free, res,
                         n_out: int):
    """Scan every statically-routed lane over its transactions.

    ``plane_free`` int32 [B, n_planes] and ``res`` int32 [B, 3, R_pad]
    (free-at, gap start, gap end) are the lane states: read, advanced and
    written back in place.  Returns ``out`` int32 [10, n_out]."""
    B = lanes.shape[0]
    F0, N = tables.dist.shape[1], tables.dist.shape[2]
    L0 = tables.cmask.shape[-1] - F0 - N
    out = torch.zeros((N_OUT, n_out), dtype=torch.int32, device=lanes.device)
    t = lanes[:, 0].long()
    scal = tables.scal[t]
    sc = {k: scal[:, j] for j, k in enumerate(STATIC_SCALARS)}
    sc["t"] = t
    fc_nearest = sc["fc_nearest"] != 0
    count_bus = sc["count_bus"] != 0
    hold = sc["hold"] != 0
    rows = torch.arange(B, device=lanes.device)
    fsl = slice(L0, L0 + F0)
    n_steps = int(lanes[:, 2].max()) if B else 0
    for i in range(n_steps):
        active, tx = _lane_inputs(lanes, txns, i)
        arrival, kind, plane, node = tx[0], tx[1], tx[2].long(), tx[3].long()
        nbytes, op = tx[4], tx[5]
        is_read = kind == KIND_READ
        tcand = torch.maximum(arrival, plane_free[rows, plane])
        d_est = (_xfer_ticks(sc, nbytes, sc["d_est_hops"]) + sc["d_est_pad"]
                 + torch.where(hold & is_read, op, 0))
        avail = gap_avail(res[:, 1, fsl], res[:, 2, fsl], res[:, 0, fsl],
                          tcand[:, None], d_est[:, None])
        avail = torch.where(tables.fc_valid[t], avail, BIG)
        fc_near, t0_near = _fc_select(avail, tables.dist[t, :, node], tcand)
        t0 = torch.where(fc_nearest, t0_near, tcand)
        fcA = torch.where(fc_nearest, fc_near, tables.fc_fixed[t, node, 0].long())
        fcB = torch.where(fc_nearest, fc_near, tables.fc_fixed[t, node, 1].long())
        cand2 = tables.cand2[t, node]
        resA, doneA, waitA, occA, hopsA, deadA = _eval_static_cand(
            tables, sc, res, tx, is_read, t0, fcA, 0, active)
        resB, doneB, waitB, occB, hopsB, deadB = _eval_static_cand(
            tables, sc, res, tx, is_read, t0, fcB, 1, active & cand2)
        useA = torch.where(deadA, BIG, doneA) <= torch.where(
            cand2 & ~deadB, doneB, BIG)
        failed = deadA & (deadB | ~cand2)
        new_res = torch.where(useA[:, None, None], resA, resB)
        res.copy_(torch.where(active[:, None, None], new_res, res))
        done = torch.where(useA, doneA, doneB)
        wait = torch.where(useA, waitA, waitB)
        occ = torch.where(useA, occA, occB)
        hops_o = torch.where(useA, hopsA, hopsB)
        done = torch.where(failed, tcand + FAIL_TIMEOUT, done)
        wait = torch.where(failed, FAIL_TIMEOUT, wait)
        occ = torch.where(failed, 0, occ)
        hops_o = torch.where(failed, 0, hops_o)
        plane_free[rows[active], plane[active]] = done[active]
        one, zero = torch.ones_like(done), torch.zeros_like(done)
        _write_out(out, lanes, i, active, (
            done, wait, wait > 0, hops_o, one, zero, zero,
            torch.where(count_bus, occ, 0),
            torch.where(count_bus, 0, hops_o * occ), failed))
    return out


# ---------------------------------------------------------------------------
# B2: Algorithm-1 scout — one decision, the DFS walk, the lane scan
# ---------------------------------------------------------------------------


def xorshift32(x):
    """xorshift32 on uint32 values carried in int64."""
    x = x ^ ((x << 13) & MASK32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & MASK32)


def lcg_advance(x):
    """The lane rng's per-reservation advance, ``(x*A + C) | 1`` mod 2^32."""
    return ((x * LCG_MUL + LCG_ADD) & MASK32) | 1


def alg1_decide(cur, dst, entry, rng, free4, allow, cols: int):
    """Algorithm-1 decision for a batch of scouts.

    ``cur``/``dst``/``entry`` int64 [B] (entry -1 at the source), ``rng``
    int64 [B] in [0, 2^32), ``free4`` bool [B, 4] (port on mesh, link not
    busy, not yet tried from ``cur``), ``allow`` bool [B].  Prefers a free
    minimal port (X then Y), else — if allowed — any free port other than
    the entry port; ties broken by one xorshift32 draw and an unsigned mod.
    Returns ``(at_dst, has_pick, pick, is_mis, rng_next)``."""
    at_dst = cur == dst
    diffx = dst % cols - cur % cols
    diffy = dst // cols - cur // cols
    px = torch.where(diffx > 0, 0, torch.where(diffx < 0, 2, -1))
    py = torch.where(diffy > 0, 1, torch.where(diffy < 0, 3, -1))
    fx = (px >= 0) & free4.gather(1, px.clamp(min=0)[:, None])[:, 0]
    fy = (py >= 0) & free4.gather(1, py.clamp(min=0)[:, None])[:, 0]
    n_min = fx.long() + fy.long()
    iota4 = torch.arange(4, device=cur.device)
    fmis = free4 & (iota4[None, :] != entry[:, None]) & allow[:, None]
    n_mis = fmis.long().sum(dim=1)
    use_min = n_min > 0
    count = torch.where(use_min, n_min, n_mis)
    need_rng = ~at_dst & (count > 1)
    rng_next = torch.where(need_rng, xorshift32(rng), rng)
    idx = rng_next % count.clamp(min=1)
    ports = torch.cat((px[:, None], py[:, None],
                       iota4[None, :].expand(cur.shape[0], 4)), dim=1)
    flags = torch.cat(((fx & use_min)[:, None], (fy & use_min)[:, None],
                       fmis & ~use_min[:, None]), dim=1)
    sel = flags & (torch.cumsum(flags.long(), dim=1) - 1 == idx[:, None])
    pick = torch.where(sel, ports, 0).sum(dim=1)
    has_pick = (count > 0) & ~at_dst
    return at_dst, has_pick, pick, has_pick & ~use_min, rng_next


def _to_u32(x32):
    return x32.long() & MASK32


def _to_i32(x64):
    return torch.where(x64 >= 2**31, x64 - 2**32, x64).to(torch.int32)


def scout_step_ref(state, busy, tried, port_link, port_neighbor, cols: int,
                   allow_nonminimal: bool = True):
    """One Algorithm-1 step for a batch of scouts (the layout of the JAX
    ``scout_step_pallas``): state int32 [B, 8] = (cur, dst, entry, rng
    bits, flags, pick, misroute, link) — flags 0 backtrack / 1 advanced /
    2 at destination; busy int32 [B, L] 0/1; tried int32 [B, >=4N] 0/1.
    Returns ``(state', busy', tried')``."""
    cur, dst, entry = state[:, 0].long(), state[:, 1].long(), state[:, 2].long()
    rng = _to_u32(state[:, 3])
    B = cur.shape[0]
    rows = torch.arange(B, device=state.device)
    links4 = port_link.long()[cur]
    nbrs4 = port_neighbor.long()[cur]
    busy4 = busy.gather(1, links4.clamp(min=0)) != 0
    tried4 = tried.gather(1, cur[:, None] * 4 + torch.arange(4, device=state.device)) != 0
    free4 = (links4 >= 0) & ~busy4 & ~tried4
    allow = torch.full((B,), bool(allow_nonminimal), device=state.device)
    at_dst, has_pick, pick, is_mis, rng_next = alg1_decide(
        cur, dst, entry, rng, free4, allow, cols)
    link_pick = links4.gather(1, pick[:, None])[:, 0]
    nbr_pick = nbrs4.gather(1, pick[:, None])[:, 0]
    state_out = torch.stack((
        torch.where(has_pick, nbr_pick, cur), dst,
        torch.where(has_pick, (pick + 2) % 4, entry), _to_i32(rng_next),
        torch.where(at_dst, 2, torch.where(has_pick, 1, 0)),
        torch.where(has_pick, pick, -1), is_mis.long(),
        torch.where(has_pick, link_pick, 0)), dim=1).to(torch.int32)
    busy_out = (busy != 0).to(torch.int32)
    tried_out = (tried != 0).to(torch.int32)
    r = rows[has_pick]
    busy_out[r, link_pick[has_pick]] = 1
    tried_out[r, (cur * 4 + pick)[has_pick]] = 1
    return state_out, busy_out, tried_out


class WalkOut(NamedTuple):
    success: torch.Tensor  # bool [B]
    path_mask: torch.Tensor  # bool [B, L] — links of the reserved path
    hops: torch.Tensor  # int64 [B]
    steps: torch.Tensor  # int64 [B] — DFS steps incl. the final one
    misroutes: torch.Tensor  # int64 [B]


def scout_walk_ref(mesh: MeshTables, src, dst, busy0, seed, allow, walking):
    """Full DFS walks (Algorithm 1 with backtracking) for the scouts with
    ``walking`` set: push on advance, pop and free the link on backtrack,
    fail when the source has nothing left.  ``busy0`` bool [B, L] is the
    occupancy snapshot; ``seed`` int64 [B] the tie-break stream's state.
    Lanes not walking report a failed 0-step walk."""
    B, L = busy0.shape
    dev = busy0.device
    port_link, port_neighbor = mesh.port_link.long(), mesh.port_neighbor.long()
    N = port_link.shape[0]
    cap = 4 * N
    rows = torch.arange(B, device=dev)
    iota4 = torch.arange(4, device=dev)
    cur, entry = src.clone(), torch.full((B,), -1, dtype=torch.long, device=dev)
    busy = busy0.clone()
    tried = torch.zeros((B, 4 * N), dtype=torch.bool, device=dev)
    st_node = torch.zeros((B, cap), dtype=torch.long, device=dev)
    st_entry = torch.zeros_like(st_node)
    st_exit = torch.zeros_like(st_node)
    st_mis = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    depth = torch.zeros((B,), dtype=torch.long, device=dev)
    steps = torch.zeros_like(depth)
    rng = seed.clone()
    done = ~walking
    success = torch.zeros((B,), dtype=torch.bool, device=dev)
    while not bool(done.all()):
        act = ~done
        links4 = port_link[cur]
        busy4 = busy.gather(1, links4.clamp(min=0))
        tried4 = tried.gather(1, cur[:, None] * 4 + iota4[None, :])
        free4 = (links4 >= 0) & ~busy4 & ~tried4
        at_dst, has_pick, pick, is_mis, rng_next = alg1_decide(
            cur, dst, entry, rng, free4, allow, mesh.cols)
        fin = act & at_dst
        adv = act & has_pick
        bt = act & ~at_dst & ~has_pick
        fail = bt & (depth == 0)
        pop = bt & (depth > 0)
        # advance: reserve the link, mark the port tried, push the hop
        r = rows[adv]
        c, p, dpt = cur[adv], pick[adv], depth[adv]
        busy[r, port_link[c, p]] = True
        tried[r, c * 4 + p] = True
        st_node[r, dpt], st_entry[r, dpt] = c, entry[adv]
        st_exit[r, dpt], st_mis[r, dpt] = p, is_mis[adv]
        # backtrack: pop the hop and free the link it had reserved
        q = rows[pop]
        d = depth[pop] - 1
        pnode, pexit = st_node[q, d], st_exit[q, d]
        busy[q, port_link[pnode, pexit]] = False
        new_cur = cur.clone()
        new_cur[r] = port_neighbor[c, p]
        new_cur[q] = pnode
        new_entry = entry.clone()
        new_entry[r] = (p + 2) % 4
        new_entry[q] = st_entry[q, d]
        cur, entry = new_cur, new_entry
        depth = depth + adv.long() - pop.long()
        done = done | fin | fail
        success = success | fin
        steps = steps + act.long()
        rng = torch.where(act, rng_next, rng)
    in_path = torch.arange(cap, device=dev)[None, :] < depth[:, None]
    return WalkOut(success, busy & ~busy0, depth, steps,
                   (st_mis & in_path).long().sum(dim=1))


def scout_lane_scan_ref(tables: ScoutTables, mesh: MeshTables, lanes, txns,
                        plane_free, links, fcs, chips, rng, n_out: int):
    """Scan every scout-routed lane (Venice §4, one scout per reservation).

    Lane state, read, advanced and written back in place: ``plane_free``
    int32 [B, n_planes]; ``links`` [B, 3, L_pad], ``fcs`` [B, 3, n_fcs],
    ``chips`` [B, 3, N] int32 (free-at, gap start, gap end); ``rng`` int32
    [B] (uint32 bits).  Per transaction: nearest-available FC, the read
    command packet, the transfer's earliest request time, then scouts at
    successive link-free events (at most 64 tries, the last at the latest
    link free-at) until one reserves a circuit.  Returns ``out``."""
    B = lanes.shape[0]
    dev = lanes.device
    L0, n_fcs, N = links.shape[2], fcs.shape[2], chips.shape[2]
    out = torch.zeros((N_OUT, n_out), dtype=torch.int32, device=dev)
    t = lanes[:, 0].long()
    scal = tables.scal[t]
    sc = {k: scal[:, j] for j, k in enumerate(SCOUT_SCALARS)}
    allow = sc["allow_nonmin"] != 0
    hold = sc["hold"] != 0
    dead_links = tables.res_dead[t, :L0]
    fc_valid = tables.fc_valid[t, :n_fcs]
    rows = torch.arange(B, device=dev)
    rng64 = _to_u32(rng)
    hop_ns = mesh.scout_hop_ns
    n_steps = int(lanes[:, 2].max()) if B else 0
    for i in range(n_steps):
        active, tx = _lane_inputs(lanes, txns, i)
        arrival, kind, plane, node = tx[0], tx[1], tx[2].long(), tx[3].long()
        nbytes, op = tx[4], tx[5]
        is_read = kind == KIND_READ
        tcand = torch.maximum(arrival, plane_free[rows, plane])
        d_est = (_xfer_ticks(sc, nbytes, sc["d_est_hops"]) + sc["d_est_pad"]
                 + torch.where(hold & is_read, op, 0))
        avail = gap_avail(fcs[:, 1], fcs[:, 2], fcs[:, 0],
                          tcand[:, None], d_est[:, None])
        avail = torch.where(fc_valid, avail, BIG)
        fc, t0 = _fc_select(avail, tables.dist[t, :n_fcs, node], tcand)
        src = tables.fc_node[t, fc].long()
        cmd_pkt = _cmd_ticks(sc, tables.dist[t, fc, node])
        # reads: command packet now (paper mode); FC state after it
        en_cmd = active & is_read & ~hold
        f_fa, f_gs, f_ge = (fcs[rows, k, fc] for k in range(3))
        s_cmd = torch.where(en_cmd, gap_avail(f_gs, f_ge, f_fa, t0, cmd_pkt), t0)
        c_gs, c_ge, c_fa = gap_commit(f_gs, f_ge, f_fa, s_cmd, s_cmd + cmd_pkt)
        f_fa = torch.where(en_cmd, c_fa, f_fa)
        f_gs = torch.where(en_cmd, c_gs, f_gs)
        f_ge = torch.where(en_cmd, c_ge, f_ge)
        ready_r = s_cmd + cmd_pkt + op
        h_fa, h_gs, h_ge = (chips[rows, k, node] for k in range(3))
        t_nonread = torch.maximum(t0, gap_avail(h_gs, h_ge, h_fa, t0, d_est))
        t_read = torch.maximum(
            torch.maximum(ready_r, gap_avail(f_gs, f_ge, f_fa, ready_r, d_est)),
            gap_avail(h_gs, h_ge, h_fa, ready_r, d_est))
        t_xfer_req = torch.where(is_read, t_read, t_nonread)
        t_try = torch.where(hold, t0, t_xfer_req)
        # --- retry loop: first try at t_try, then at link-state events ---
        l_fa, l_gs, l_ge = links[:, 0], links[:, 1], links[:, 2]
        busy = busy_at(l_fa, l_gs, l_ge, t_try[:, None], d_est[:, None]) | dead_links
        rng64 = torch.where(active, lcg_advance(rng64), rng64)
        walk = scout_walk_ref(mesh, src, node, busy, rng64, allow, active)
        tries = active.long()
        pending = active & ~walk.success
        while bool(pending.any()):
            ev = torch.minimum(
                torch.where(l_fa > t_try[:, None], l_fa, BIG).amin(dim=1),
                torch.where(l_gs > t_try[:, None], l_gs, BIG).amin(dim=1))
            t_next = torch.maximum(ev, t_try + 1)
            t_next = torch.where(tries + 1 >= MAX_TRIES, l_fa.amax(dim=1), t_next)
            busy = busy_at(l_fa, l_gs, l_ge, t_next[:, None], d_est[:, None]) | dead_links
            rng64 = torch.where(pending, lcg_advance(rng64), rng64)
            w2 = scout_walk_ref(mesh, src, node, busy, rng64, allow, pending)
            walk = WalkOut(*(torch.where(pending.view(-1, *[1] * (a.dim() - 1)), b, a)
                             for a, b in zip(walk, w2)))
            t_try = torch.where(pending, t_next, t_try)
            tries = tries + pending.long()
            pending = pending & ~w2.success & (tries < MAX_TRIES)
        t_resv = t_try
        hops_o = walk.hops
        rtt = _ceil_div((walk.steps + hops_o) * hop_ns, TICK_NS)
        start = t_resv + rtt
        cmd_v = _cmd_ticks(sc, hops_o)
        xfer_v = _xfer_ticks(sc, nbytes, hops_o)
        end_p = start + torch.where(is_read, xfer_v, cmd_v + xfer_v)
        done_p = torch.where(is_read, end_p, end_p + op)
        wait_p = (s_cmd - t0) + (start - t_xfer_req)
        done_r_h = start + cmd_v + op + xfer_v
        data_end_w = start + cmd_v + xfer_v
        circuit_end = torch.where(is_read, done_r_h, data_end_w)
        done_h = torch.where(is_read, done_r_h, data_end_w + op)
        commit_end = torch.where(hold, circuit_end, end_p)
        done = torch.where(hold, done_h, done_p)
        wait = torch.where(hold, start - t0, wait_p)
        fail = ~walk.success
        ok = active & walk.success
        done = torch.where(fail, tcand + FAIL_TIMEOUT, done)
        wait = torch.where(fail, FAIL_TIMEOUT, wait)
        # commits: links of the path, the FC, the chip's I/O interface
        new_links = commit_mask(links, walk.path_mask, t_resv, commit_end)
        links.copy_(torch.where(ok[:, None, None], new_links, links))
        c_gs, c_ge, c_fa = gap_commit(f_gs, f_ge, f_fa, t_resv, commit_end)
        f_new = torch.stack((torch.where(ok, c_fa, f_fa), torch.where(ok, c_gs, f_gs),
                             torch.where(ok, c_ge, f_ge)), dim=1)
        fcs[rows[active], :, fc[active]] = f_new[active].to(torch.int32)
        c_gs, c_ge, c_fa = gap_commit(h_gs, h_ge, h_fa, t_resv, commit_end)
        h_new = torch.stack((torch.where(ok, c_fa, h_fa), torch.where(ok, c_gs, h_gs),
                             torch.where(ok, c_ge, h_ge)), dim=1)
        chips[rows[active], :, node[active]] = h_new[active].to(torch.int32)
        plane_free[rows[active], plane[active]] = done[active].to(torch.int32)
        zero = torch.zeros_like(done)
        _write_out(out, lanes, i, active, (
            done, wait, (tries > 1) | fail, hops_o, tries, walk.steps,
            walk.misroutes, zero,
            torch.where(fail, 0, hops_o * (commit_end - t_resv)), fail))
    rng.copy_(_to_i32(rng64))
    return out
