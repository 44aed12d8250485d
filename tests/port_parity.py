"""Helpers shared by the ``test_torch_*`` files (parity of the PyTorch port
``repro_torch`` with the JAX reference ``repro``).

``jax_reference()`` wraps calls into the JAX package so that they leave
nothing behind: both persistent compilation stores are off inside it (the
AOT executable store through ``repro.ssd.exec_cache.cache_dir``, JAX's own
compilation cache through its scoped context), and the run/decomposition
memo caches of ``repro.ssd.bench`` are swapped for empty ones and restored.
``torch_threads()`` keeps the port's CPU kernels to one thread while a test
module runs, then restores the previous count.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch


@contextlib.contextmanager
def jax_reference():
    from repro.ssd import bench, exec_cache

    try:  # scoped (thread-local) switch, restored on exit
        from jax._src.config import enable_compilation_cache
        no_t2 = enable_compilation_cache(False)
    except ImportError:
        no_t2 = contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, no_t2:
        mp.setattr(exec_cache, "cache_dir", lambda: None)
        mp.setattr(bench, "_RUN_CACHE", {})
        mp.setattr(bench, "_DECOMP_CACHE", {})
        yield


@contextlib.contextmanager
def torch_threads(n: int = 1):
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


SIM_FIELDS = (
    "completion", "latency", "req_latency", "wait", "conflict", "hops",
    "tries", "misroutes", "exec_ticks", "bus_hold_ticks", "link_hold_ticks",
    "flash_energy_j", "transfer_energy_j", "static_energy_j",
    "req_completion", "failed", "req_failed",
)


def assert_same_result(got, want) -> None:
    """Every ``SimResult`` field equal: arrays element by element (dtype
    included), ints and float64 energies exactly."""
    assert got.design == want.design
    for f in SIM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            a = np.asarray(a)
            assert a.dtype == b.dtype, f"{want.design}.{f} dtype {a.dtype} != {b.dtype}"
            assert np.array_equal(a, b), f"{want.design}.{f} differs"
        else:
            assert type(a) is type(b) and a == b, f"{want.design}.{f}: {a!r} != {b!r}"
    assert got.req_tenant is None and want.req_tenant is None
