"""Deterministic PRNG shared by the reference router and the scout kernels.

The paper uses a 2-bit LFSR inside each router for the random output-port
tie-break (§4.3).  The scalar reference router, the plain PyTorch scout and
the CUDA scout kernels must make bit-identical choices, so all of them use
the same xorshift32 stream seeded per scout.  (A 2-bit LFSR would repeat with
period 3; xorshift32 keeps the same "cheap hardware PRNG" spirit while letting
the simulator draw many tie-breaks per scout without short cycles.)
"""
from __future__ import annotations

MASK32 = 0xFFFFFFFF

# Per-reservation advance of a lane's scout seed (``(x*A + C) | 1`` mod 2^32).
LCG_MUL = 747796405
LCG_ADD = 2891336453


def xorshift32_py(state: int) -> int:
    """One xorshift32 step on a python int (reference implementation)."""
    x = state & MASK32
    x ^= (x << 13) & MASK32
    x ^= x >> 17
    x ^= (x << 5) & MASK32
    return x & MASK32
