"""``static_lane_scan``: the statically-routed lane scan (kernel B1).

Replaces the TPU kernel ``repro/kernels/batched_step.py:52``
(``lane_tiled_step`` over ``sim._make_batched_static_step``).  The CUDA
kernel (``csrc/static_scan.cu``) runs every lane's whole scan in one launch,
one thread per lane with the lane state in shared memory; its note says
what bounds it.  CPU tensors take the plain PyTorch version
(``ref.static_lane_scan_ref``); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    N_OUT,
    STATIC_SCALARS,
    StaticTables,
    static_lane_scan_ref,
)


def mask_lists(cmask: torch.Tensor) -> torch.Tensor:
    """Combined masks bool [..., R] → sorted resource-id lists int32
    [..., M] padded with -1 (M = the longest mask)."""
    R = cmask.shape[-1]
    M = max(1, int(cmask.sum(dim=-1).max())) if cmask.numel() else 1
    ids = torch.where(cmask, torch.arange(R, device=cmask.device), R)
    ids = ids.sort(dim=-1).values[..., :M]
    return torch.where(ids == R, -1, ids).to(torch.int32).contiguous()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"static_lane_scan: {msg}")


def static_lane_scan(tables: StaticTables, lanes: torch.Tensor,
                     txns: torch.Tensor, plane_free: torch.Tensor,
                     res: torch.Tensor, n_out: int) -> torch.Tensor:
    """Scan every statically-routed lane; see ``ref.static_lane_scan_ref``
    for the layouts.  Lane state (``plane_free``, ``res``) is updated in
    place.  Returns ``out`` int32 [10, n_out]."""
    tensors = (*tables, lanes, txns, plane_free, res)
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return static_lane_scan_ref(tables, lanes, txns, plane_free, res, n_out)
    _require(kinds == {"cuda"}, f"tensors on mixed devices {sorted(kinds)}")
    T, F0, N, _, R = tables.cmask.shape
    B, P = plane_free.shape
    i32 = torch.int32
    _require(tables.scal.shape == (T, len(STATIC_SCALARS)), "scal shape")
    _require(tables.hops.shape == (T, F0, N, 2) and tables.dist.shape == (T, F0, N)
             and tables.fc_fixed.shape == (T, N, 2) and tables.cand2.shape == (T, N)
             and tables.fc_valid.shape == (T, F0) and tables.res_dead.shape == (T, R),
             "table shapes disagree")
    _require(all(t.dtype == i32 for t in (tables.scal, tables.hops, tables.dist,
                                          tables.fc_fixed, lanes, txns, plane_free, res)),
             "int tensors must be int32")
    _require(all(t.dtype == torch.bool for t in (tables.cmask, tables.cand2,
                                                 tables.fc_valid, tables.res_dead)),
             "mask tensors must be bool")
    _require(lanes.shape == (B, 4) and res.shape == (B, 3, R), "lane state shapes")
    _require(txns.dim() == 2 and txns.shape[0] == 6, "txns must be [6, T]")
    _require(all(t.is_contiguous() for t in tensors), "tensors must be contiguous")
    mask_idx = mask_lists(tables.cmask)
    out = torch.empty((N_OUT, n_out), dtype=i32, device=lanes.device)
    lib = build.library("static_scan")
    p = build.ptr
    code = lib.static_lane_scan_launch(
        p(lanes), B, p(tables.scal), tables.scal.shape[1], p(mask_idx),
        mask_idx.shape[-1], p(tables.hops), p(tables.cand2), p(tables.fc_fixed),
        p(tables.dist), p(tables.fc_valid), p(tables.res_dead), F0, N, R,
        p(txns), txns.shape[1], p(plane_free), P, p(res), p(out), n_out,
        torch.cuda.current_stream(lanes.device).cuda_stream)
    build.check(lib, code, "static_lane_scan")
    build.LAUNCHES["static_lane_scan"] += 1
    return out
