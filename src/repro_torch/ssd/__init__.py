"""SSD substrate: Table-1 configs, FTL, the design registry and the
lane-scan simulator that runs every registered design on the GPU."""
from repro_torch.ssd.config import (
    TICK_NS,
    PowerModel,
    SSDConfig,
    cost_optimized,
    perf_optimized,
)
from repro_torch.ssd.designs import DESIGNS, REGISTRY, DesignSpec, LaneTables, lower_designs
from repro_torch.ssd.ftl import Transactions, decompose_trace
from repro_torch.ssd.sim import SimResult, simulate, simulate_sweep

__all__ = [
    "TICK_NS", "PowerModel", "SSDConfig", "cost_optimized", "perf_optimized",
    "DESIGNS", "REGISTRY", "DesignSpec", "LaneTables", "lower_designs",
    "Transactions", "decompose_trace", "SimResult", "simulate", "simulate_sweep",
]
