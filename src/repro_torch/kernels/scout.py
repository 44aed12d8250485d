"""Algorithm-1 scout kernels (kernel B2): ``scout_lane_scan`` and
``scout_step``.

Replace the TPU kernel ``repro/kernels/scout_step.py:219``
(``scout_step_pallas``) and the JAX code that drove it (the DFS loop
``repro/kernels/ops.py:40-157``, the retry loop ``repro/ssd/sim.py:347-407``).
``scout_lane_scan`` fuses the decision, the DFS and the retry loop into one
launch for every scout-routed lane; ``scout_step`` runs one decision for a
batch of scouts in the layout of ``scout_step_pallas``, so it can be held
decision by decision against the plain version.  Both run the same device
function (``csrc/common.cuh``).  CPU tensors take the plain PyTorch
versions in ``ref.py``; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    N_OUT,
    SCOUT_SCALARS,
    MeshTables,
    ScoutTables,
    scout_lane_scan_ref,
    scout_step_ref,
)


def _devices(tensors, name: str) -> str:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"{name}: tensors on devices {sorted(kinds)}")
    return kinds.pop()


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def scout_lane_scan(tables: ScoutTables, mesh: MeshTables, lanes, txns,
                    plane_free, links, fcs, chips, rng, n_out: int):
    """Scan every scout-routed lane; see ``ref.scout_lane_scan_ref`` for
    the layouts.  Lane state is updated in place.  Returns ``out`` int32
    [10, n_out]."""
    name = "scout_lane_scan"
    tensors = (*tables, mesh.port_link, mesh.port_neighbor, lanes, txns,
               plane_free, links, fcs, chips, rng)
    if _devices(tensors, name) == "cpu":
        return scout_lane_scan_ref(tables, mesh, lanes, txns, plane_free,
                                   links, fcs, chips, rng, n_out)
    T, F0, N = tables.dist.shape
    R = tables.res_dead.shape[1]
    B, P = plane_free.shape
    L0, NF = links.shape[2], fcs.shape[2]
    i32 = torch.int32
    _require(tables.scal.shape == (T, len(SCOUT_SCALARS)), name, "scal shape")
    _require(tables.fc_valid.shape == (T, F0) and tables.fc_node.shape == (T, F0),
             name, "table shapes disagree")
    _require(mesh.port_link.shape == (N, 4) and mesh.port_neighbor.shape == (N, 4),
             name, "mesh table shapes")
    _require(lanes.shape == (B, 4) and links.shape == (B, 3, L0)
             and fcs.shape == (B, 3, NF) and chips.shape == (B, 3, N)
             and rng.shape == (B,) and NF <= F0 and L0 <= R, name, "lane state shapes")
    _require(txns.dim() == 2 and txns.shape[0] == 6, name, "txns must be [6, T]")
    _require(all(t.dtype == i32 for t in (tables.scal, tables.dist, tables.fc_node,
                                          mesh.port_link, mesh.port_neighbor, lanes,
                                          txns, plane_free, links, fcs, chips, rng)),
             name, "int tensors must be int32")
    _require(tables.fc_valid.dtype == torch.bool and tables.res_dead.dtype == torch.bool,
             name, "mask tensors must be bool")
    _require(all(t.is_contiguous() for t in tensors), name, "tensors must be contiguous")
    out = torch.empty((N_OUT, n_out), dtype=i32, device=lanes.device)
    lib = build.library("scout")
    p = build.ptr
    code = lib.scout_lane_scan_launch(
        p(lanes), B, p(tables.scal), tables.scal.shape[1], p(tables.dist),
        p(tables.fc_valid), p(tables.fc_node), p(tables.res_dead), F0, N, R,
        p(mesh.port_link), p(mesh.port_neighbor), mesh.cols, mesh.scout_hop_ns,
        p(txns), txns.shape[1], p(plane_free), P, p(links), L0, p(fcs), NF,
        p(chips), p(rng), p(out), n_out,
        torch.cuda.current_stream(lanes.device).cuda_stream)
    build.check(lib, code, name)
    build.LAUNCHES[name] += 1
    return out


def scout_step(state, busy, tried, port_link, port_neighbor, cols: int,
               allow_nonminimal: bool = True):
    """One Algorithm-1 decision per scout: state int32 [B, 8], busy int32
    [B, L], tried int32 [B, >=4N]; returns ``(state', busy', tried')``."""
    name = "scout_step"
    tensors = (state, busy, tried, port_link, port_neighbor)
    if _devices(tensors, name) == "cpu":
        return scout_step_ref(state, busy, tried, port_link, port_neighbor,
                              cols, allow_nonminimal)
    B = state.shape[0]
    N = port_link.shape[0]
    _require(state.shape == (B, 8) and busy.shape[0] == B and tried.shape[0] == B
             and tried.shape[1] >= 4 * N and port_neighbor.shape == (N, 4)
             and port_link.shape == (N, 4), name, "shapes")
    _require(all(t.dtype == torch.int32 for t in tensors), name, "tensors must be int32")
    _require(all(t.is_contiguous() for t in tensors), name, "tensors must be contiguous")
    _require(int(port_link.max()) < busy.shape[1], name, "busy narrower than the link ids")
    state_out = torch.empty_like(state)
    busy_out = torch.empty_like(busy)
    tried_out = torch.empty_like(tried)
    lib = build.library("scout")
    p = build.ptr
    code = lib.scout_step_launch(
        p(state), p(busy), busy.shape[1], p(tried), tried.shape[1],
        p(port_link), p(port_neighbor), cols, int(bool(allow_nonminimal)), B,
        p(state_out), p(busy_out), p(tried_out),
        torch.cuda.current_stream(state.device).cuda_stream)
    build.check(lib, code, name)
    build.LAUNCHES[name] += 1
    return state_out, busy_out, tried_out
