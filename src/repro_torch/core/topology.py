"""2D-mesh topology of flash nodes (Venice §4.1).

A flash node = (unmodified flash chip) + (router chip). Routers form an
``R x C`` 2D mesh; flash controller ``f`` (one per row, R total) attaches to the
west-edge node ``(f, 0)`` through its injection link.  Links are *bidirectional*
and reserved as a unit (Venice reserves the forward and backward directions of
each hop together so a single circuit serves both the command (forward) and read
data (backward) phases).

Everything here is static numpy — the kernels receive the tables as tensors.

Port convention (matches Algorithm 1's Right/Up/Left/Down):
  RIGHT = 0 : (r, c) -> (r, c+1)    Diff_x > 0
  UP    = 1 : (r, c) -> (r+1, c)    Diff_y > 0   (paper: row index grows "Up")
  LEFT  = 2 : (r, c) -> (r, c-1)    Diff_x < 0
  DOWN  = 3 : (r, c) -> (r-1, c)    Diff_y < 0
  EJECT = 4 : router -> local flash chip (not a mesh link; never reserved)
"""
from __future__ import annotations

import dataclasses

import numpy as np

RIGHT, UP, LEFT, DOWN, EJECT = 0, 1, 2, 3, 4
N_PORTS = 4  # mesh ports (EJECT handled separately)
OPPOSITE = np.array([LEFT, DOWN, RIGHT, UP], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Static description of an R x C flash-node mesh with R flash controllers."""

    rows: int
    cols: int
    # --- derived tables (numpy, shape noted) ---
    n_nodes: int
    n_links: int
    port_link: np.ndarray      # [n_nodes, 4] link id per port, -1 if off-mesh
    port_neighbor: np.ndarray  # [n_nodes, 4] neighbor node id per port, -1 if none
    fc_node: np.ndarray        # [rows] node id each flash controller injects into
    link_endpoints: np.ndarray  # [n_links, 2] node ids (for tests / invariants)

    @property
    def n_fcs(self) -> int:
        return self.rows

    def node_id(self, r: int, c: int) -> int:
        return r * self.cols + c

    def node_rc(self, node: int) -> tuple[int, int]:
        return divmod(node, self.cols)


def build_mesh(rows: int, cols: int) -> MeshTopology:
    """Build the static routing tables for an ``rows x cols`` mesh.

    Link ids: horizontal links first (row-major, ``rows*(cols-1)`` of them),
    then vertical (col-major, ``cols*(rows-1)``).
    """
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh must be at least 1x1, got {rows}x{cols}")
    n_nodes = rows * cols
    n_h = rows * (cols - 1)
    n_v = cols * (rows - 1)
    n_links = n_h + n_v

    def h_link(r: int, c: int) -> int:  # (r,c)-(r,c+1)
        return r * (cols - 1) + c

    def v_link(r: int, c: int) -> int:  # (r,c)-(r+1,c)
        return n_h + c * (rows - 1) + r

    port_link = np.full((n_nodes, N_PORTS), -1, dtype=np.int32)
    port_neighbor = np.full((n_nodes, N_PORTS), -1, dtype=np.int32)
    link_endpoints = np.zeros((n_links, 2), dtype=np.int32)

    for r in range(rows):
        for c in range(cols):
            n = r * cols + c
            if c + 1 < cols:
                port_link[n, RIGHT] = h_link(r, c)
                port_neighbor[n, RIGHT] = n + 1
                link_endpoints[h_link(r, c)] = (n, n + 1)
            if c - 1 >= 0:
                port_link[n, LEFT] = h_link(r, c - 1)
                port_neighbor[n, LEFT] = n - 1
            if r + 1 < rows:
                port_link[n, UP] = v_link(r, c)
                port_neighbor[n, UP] = n + cols
                link_endpoints[v_link(r, c)] = (n, n + cols)
            if r - 1 >= 0:
                port_link[n, DOWN] = v_link(r - 1, c)
                port_neighbor[n, DOWN] = n - cols

    fc_node = np.array([r * cols for r in range(rows)], dtype=np.int32)

    return MeshTopology(
        rows=rows,
        cols=cols,
        n_nodes=n_nodes,
        n_links=n_links,
        port_link=port_link,
        port_neighbor=port_neighbor,
        fc_node=fc_node,
        link_endpoints=link_endpoints,
    )


def xy_path_links(topo: MeshTopology, src_node: int, dst_node: int) -> np.ndarray:
    """Deterministic dimension-order (X-then-Y) path, used by the NoSSD baseline.

    Returns the link ids along the path (numpy int32 vector, possibly empty).
    """
    r0, c0 = topo.node_rc(src_node)
    r1, c1 = topo.node_rc(dst_node)
    links = []
    r, c = r0, c0
    while c != c1:
        step = 1 if c1 > c else -1
        port = RIGHT if step == 1 else LEFT
        links.append(topo.port_link[r * topo.cols + c, port])
        c += step
    while r != r1:
        step = 1 if r1 > r else -1
        port = UP if step == 1 else DOWN
        links.append(topo.port_link[r * topo.cols + c, port])
        r += step
    return np.asarray(links, dtype=np.int32)


def all_xy_paths(topo: MeshTopology) -> np.ndarray:
    """[n_fcs, n_nodes, max_len] link ids (padded with -1) for every FC->chip XY
    path, plus [n_fcs, n_nodes] hop counts.  Used to lower the NoSSD design.
    """
    max_len = (topo.rows - 1) + (topo.cols - 1)
    max_len = max(max_len, 1)
    paths = np.full((topo.n_fcs, topo.n_nodes, max_len), -1, dtype=np.int32)
    hops = np.zeros((topo.n_fcs, topo.n_nodes), dtype=np.int32)
    for f in range(topo.n_fcs):
        src = int(topo.fc_node[f])
        for n in range(topo.n_nodes):
            p = xy_path_links(topo, src, n)
            paths[f, n, : len(p)] = p
            hops[f, n] = len(p)
    return paths, hops
