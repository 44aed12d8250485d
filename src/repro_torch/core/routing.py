"""Venice Algorithm 1 — non-minimal fully-adaptive routing (reference impl).

This is the *oracle*: a plain-python/numpy depth-first scout walk with the
paper's exact semantics (§4.2-§4.3):

  * per hop, prefer FREE output ports on a MINIMAL path toward the
    destination (random tie-break between the two dimension candidates);
  * if no minimal port is free, MISROUTE over any free non-minimal port
    (never the port we arrived on);
  * if nothing is free, BACKTRACK to the upstream router, cancelling the
    reservation of the link we arrived on;
  * livelock bound: each *output port* of each router can be reserved at
    most once per scout (⇒ a router is revisited ≤ 3 times on a 4-port
    mesh router, paper footnote 5), so the walk is a terminating DFS;
  * deadlock cannot happen because a scout never blocks — it backtracks.

The scout kernels (``kernels/scout.py``: the CUDA walk and its plain PyTorch
version) must match this function decision-for-decision (same xorshift32
tie-break stream); ``tests/test_torch_scout.py`` enforces parity.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.rng import xorshift32_py
from repro_torch.core.topology import MeshTopology, N_PORTS, OPPOSITE

# Fixed candidate ordering for random selection (index = port id).
_PORT_ORDER = (0, 1, 2, 3)  # RIGHT, UP, LEFT, DOWN


@dataclasses.dataclass
class ScoutResult:
    """Outcome of one scout walk."""

    success: bool
    path_nodes: list  # nodes visited on the final reserved path (src..dst)
    path_links: np.ndarray  # link ids of the final reserved path (len = hops)
    hops: int
    steps: int  # total DFS steps (incl. backtracks) — scout latency proxy
    backtracks: int
    misroutes: int  # hops taken on non-minimal ports
    minimal_hops: int  # Manhattan distance src->dst (for non-minimality stats)


def minimal_ports(topo: MeshTopology, node: int, dst: int) -> list:
    """Output ports of ``node`` on some minimal path to ``dst`` (Alg. 1 lines 5-26)."""
    r, c = divmod(node, topo.cols)
    rd, cd = divmod(dst, topo.cols)
    ports = []
    # Diff_x = dst_col - col ; Diff_y = dst_row - row (paper: ID%Nc / ID/Nc)
    if cd > c:
        ports.append(0)  # RIGHT
    elif cd < c:
        ports.append(2)  # LEFT
    if rd > r:
        ports.append(1)  # UP
    elif rd < r:
        ports.append(3)  # DOWN
    return ports


def scout_route_ref(
    topo: MeshTopology,
    src_node: int,
    dst_node: int,
    link_busy: np.ndarray,
    seed: int,
    allow_nonminimal: bool = True,
) -> ScoutResult:
    """Walk one scout from ``src_node`` to ``dst_node`` over the mesh.

    ``link_busy`` is the *global* reservation state (bool [n_links]); the walk
    additionally treats links it has reserved itself as busy.  The input array
    is NOT mutated — on success the caller commits ``path_links``.

    ``allow_nonminimal=False`` degrades Algorithm 1 to *minimal* fully-adaptive
    routing (used for ablation in the benchmarks).
    """
    busy = link_busy.copy()
    tried = np.zeros((topo.n_nodes, N_PORTS), dtype=bool)
    # DFS stack of (node, entry_port, exit_port)
    stack: list = []
    cur = src_node
    entry = -1  # port we arrived on at `cur` (-1 at the source)
    rng = seed
    steps = 0
    backtracks = 0
    misroutes_mask: list = []  # parallel to stack: was this hop a misroute?
    max_steps = 8 * topo.n_nodes + 8  # hard safety bound (DFS is ≤ 4*n pushes + pops)

    while True:
        steps += 1
        if steps > max_steps:  # pragma: no cover - DFS bound makes this unreachable
            raise RuntimeError("scout exceeded DFS bound; invariant broken")
        if cur == dst_node:
            links = np.array(
                [topo.port_link[n, p] for (n, _, p) in stack], dtype=np.int32
            )
            nodes = [src_node] + [topo.port_neighbor[n, p] for (n, _, p) in stack]
            r0, c0 = divmod(src_node, topo.cols)
            r1, c1 = divmod(dst_node, topo.cols)
            return ScoutResult(
                success=True,
                path_nodes=nodes,
                path_links=links,
                hops=len(links),
                steps=steps,
                backtracks=backtracks,
                misroutes=int(sum(misroutes_mask)),
                minimal_hops=abs(r0 - r1) + abs(c0 - c1),
            )

        def free(p: int) -> bool:
            lnk = topo.port_link[cur, p]
            return lnk >= 0 and not busy[lnk] and not tried[cur, p]

        # --- minimal candidates (Alg. 1 lines 2-26) ---
        cands = [p for p in minimal_ports(topo, cur, dst_node) if free(p)]
        is_misroute = False
        if not cands and allow_nonminimal:
            # --- misroute: any free port except the one we arrived on (ll. 34-45)
            cands = [p for p in _PORT_ORDER if p != entry and free(p)]
            is_misroute = True

        if cands:
            if len(cands) > 1:
                rng = xorshift32_py(rng)
                pick = cands[rng % len(cands)]
            else:
                pick = cands[0]
            tried[cur, pick] = True
            busy[topo.port_link[cur, pick]] = True
            stack.append((cur, entry, pick))
            misroutes_mask.append(is_misroute)
            entry = int(OPPOSITE[pick])
            cur = int(topo.port_neighbor[cur, pick])
        else:
            # --- backtrack (Alg. 1 lines 46-47): cancel the upstream reservation
            if not stack:
                r0, c0 = divmod(src_node, topo.cols)
                r1, c1 = divmod(dst_node, topo.cols)
                return ScoutResult(
                    success=False,
                    path_nodes=[src_node],
                    path_links=np.zeros((0,), dtype=np.int32),
                    hops=0,
                    steps=steps,
                    backtracks=backtracks,
                    misroutes=0,
                    minimal_hops=abs(r0 - r1) + abs(c0 - c1),
                )
            backtracks += 1
            pnode, pentry, pexit = stack.pop()
            misroutes_mask.pop()
            busy[topo.port_link[pnode, pexit]] = False
            cur = pnode
            entry = pentry
