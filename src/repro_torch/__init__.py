"""PyTorch + CUDA port of the Venice SSD simulator.

The JAX package ``repro`` is the reference; this package reproduces its
main path — trace, FTL, design lowering, per-lane scan, ``SimResult`` and
the fig-9/10/13 speedups — element by element, with both Pallas kernels
rewritten as CUDA kernels for Hopper.  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
from repro_torch.ssd import (
    DESIGNS,
    cost_optimized,
    decompose_trace,
    perf_optimized,
    simulate,
    simulate_sweep,
)
from repro_torch.ssd.bench import run_workload, run_workloads

__all__ = ["DESIGNS", "cost_optimized", "decompose_trace", "perf_optimized",
           "run_workload", "run_workloads", "simulate", "simulate_sweep"]
