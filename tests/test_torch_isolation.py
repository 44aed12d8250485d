"""Boundaries of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package ``repro`` (by the root of every import, so ``repro_torch`` itself
  is allowed).
* The entry points run on CUDA by default: without a CUDA device and
  without ``device="cpu"`` they raise instead of running on the CPU.
* A kernel wrapper takes its plain version only for CPU tensors; any other
  device launches the kernel or raises.
"""
import ast
import pathlib

import pytest
import torch

import repro_torch
from repro_torch.kernels import ref as kref
from repro_torch.kernels.scout import scout_step
from repro_torch.kernels.static_scan import static_lane_scan
from repro_torch.ssd import bench, figs, perf_optimized, sim

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _import_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    roots = set(_import_roots(path))
    assert "jax" not in roots and "jaxlib" not in roots
    assert "repro" not in roots


def test_sources_found():
    assert len(SOURCES) > 15 and pathlib.Path(repro_torch.__file__).parent.name == "repro_torch"


def _txns():
    import numpy as np

    return {"arrival": np.zeros(2, np.int64), "kind": np.zeros(2, np.int64),
            "plane": np.array([0, 2]), "node": np.array([0, 1]),
            "row": np.array([0, 0]), "nbytes": np.full(2, 4096),
            "req": np.arange(2)}


ENTRY_POINTS = {
    "simulate": lambda: sim.simulate(perf_optimized(), _txns(), "baseline"),
    "simulate_sweep": lambda: repro_torch.simulate_sweep(perf_optimized(), _txns(),
                                                         ("baseline", "venice")),
    "run_workload": lambda: bench.run_workload("hm_0", perf_optimized(rows=2, cols=2),
                                               ("baseline",), 10),
    "sec31_example": lambda: figs.sec31_example(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_cuda_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        sim.resolve_device("cuda")


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    meta = torch.device("meta")
    st = torch.zeros((4, 8), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        scout_step(st, st, st, st[:, :4], st[:, :4], 2)
    i32 = dict(dtype=torch.int32, device=meta)
    tables = kref.StaticTables(
        scal=torch.zeros((1, len(kref.STATIC_SCALARS)), **i32),
        cmask=torch.zeros((1, 2, 4, 2, 10), dtype=torch.bool, device=meta),
        hops=torch.zeros((1, 2, 4, 2), **i32), cand2=torch.zeros((1, 4), dtype=torch.bool),
        fc_fixed=torch.zeros((1, 4, 2), **i32), dist=torch.zeros((1, 2, 4), **i32),
        fc_valid=torch.zeros((1, 2), dtype=torch.bool), res_dead=torch.zeros((1, 10), dtype=torch.bool))
    with pytest.raises(ValueError, match="mixed devices"):
        static_lane_scan(tables, torch.zeros((1, 4), **i32), torch.zeros((6, 1), **i32),
                         torch.zeros((1, 8), **i32), torch.zeros((1, 3, 10), **i32), 1)
