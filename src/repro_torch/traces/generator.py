"""Synthetic storage traces calibrated to paper Table 2 (19 real workloads)
and Table 3 (6 mixed workloads).

The original MSR/YCSB/Slacker/SYSTOR/RocksDB traces are not redistributable
inside this container, so we synthesize statistically-matched replacements:
per workload we reproduce the *read ratio*, *mean request size* and *mean
inter-request arrival time* from Table 2 exactly (in expectation), with
heavy-tailed size and arrival distributions and a hot/cold zipf-like address
mixture typical of the original suites.  Tests validate the statistics
converge to the table's targets.
"""
from __future__ import annotations

import zlib
from typing import Dict, NamedTuple

import numpy as np


class WorkloadStats(NamedTuple):
    """The Table-2 summary triple every synthetic workload is calibrated to."""

    read_pct: float  # % of requests that are reads
    avg_kb: float  # mean request size, KB
    avg_iat_us: float  # mean inter-request arrival time, us


# name -> WorkloadStats, verbatim from Table 2
WORKLOADS: Dict[str, WorkloadStats] = {
    "hm_0": WorkloadStats(36, 8.8, 58),
    "mds_0": WorkloadStats(12, 9.6, 268),
    "proj_3": WorkloadStats(95, 9.6, 19),
    "prxy_0": WorkloadStats(3, 7.2, 242),
    "rsrch_0": WorkloadStats(9, 9.6, 129),
    "src1_0": WorkloadStats(56, 43.2, 49),
    "src2_1": WorkloadStats(98, 59.2, 50),
    "usr_0": WorkloadStats(40, 22.8, 98),
    "wdev_0": WorkloadStats(20, 9.2, 162),
    "web_1": WorkloadStats(54, 29.6, 67),
    "YCSB_B": WorkloadStats(99, 65.7, 13),
    "YCSB_D": WorkloadStats(99, 62, 14),
    "jenkins": WorkloadStats(94, 33.4, 615),
    "postgres": WorkloadStats(82, 13.3, 382),
    "LUN0": WorkloadStats(76, 20.4, 218),
    "LUN2": WorkloadStats(73, 16, 320),
    "LUN3": WorkloadStats(7, 7.7, 3127),
    "ssd-00": WorkloadStats(91, 90, 5),
    "ssd-10": WorkloadStats(99, 11.5, 2),
}

# Table 3: mix name -> constituent workloads
MIXES: Dict[str, tuple] = {
    "mix1": ("src2_1", "proj_3"),
    "mix2": ("src2_1", "proj_3", "YCSB_D"),
    "mix3": ("prxy_0", "rsrch_0"),
    "mix4": ("prxy_0", "rsrch_0", "mds_0"),
    "mix5": ("prxy_0", "src2_1"),
    "mix6": ("prxy_0", "src2_1", "usr_0"),
}

_ALIGN = 4096  # requests are 4KB-aligned multiples (block-device granularity)

def _seq_stream_offsets(
    off: np.ndarray,
    sz_align: np.ndarray,
    is_seq: np.ndarray,
    stream_of: np.ndarray,
    n_align: int,
) -> np.ndarray:
    """Resolve sequential-stream addresses without a per-request loop.

    Semantics (the former scalar loop): every request advances its stream's
    cursor to ``offset + size``; a sequential request first *reads* the
    cursor (mod ``n_align``) as its offset, a random request resets the
    cursor to its own random offset.  Because ``(x % n + s) % n == (x + s)
    % n``, a run of sequential requests between two resets is a prefix sum:
    ``offset_k = (base + sum of sizes of earlier seq requests in the run)
    % n_align`` where ``base`` is the cursor left by the last reset (0 at
    stream start).  That turns the whole recurrence into one grouped
    cumulative sum over (stream, arrival-order) — pinned bit-exactly to the
    scalar loop by the JAX package's ``tests/test_traces.py``.
    """
    n = len(off)
    if n == 0 or not is_seq.any():
        return off
    order = np.argsort(stream_of, kind="stable")  # stream-major, arrival order
    s_s = stream_of[order]
    seq_s = is_seq[order]
    off_s = off[order].copy()
    sz_s = sz_align[order]
    # exclusive prefix sum of seq sizes (within the stream-major layout)
    excl = np.concatenate(([0], np.cumsum(np.where(seq_s, sz_s, 0))))[:-1]
    idx = np.arange(n, dtype=np.int64)
    # latest reset (= non-seq request) at or before each position …
    reset_at = np.maximum.accumulate(np.where(~seq_s, idx, -1))
    # … clipped to the current stream: positions before the stream's first
    # request belong to another stream ⇒ base cursor 0
    starts = np.concatenate(([0], np.flatnonzero(s_s[1:] != s_s[:-1]) + 1))
    counts = np.diff(np.concatenate((starts, [n])))
    start_of = np.repeat(starts, counts)
    in_stream = reset_at >= start_of
    r = np.clip(reset_at, 0, None)
    base = np.where(in_stream, off_s[r] + sz_s[r], 0)
    run_sum = excl - np.where(in_stream, excl[r], excl[start_of])
    off_s[seq_s] = (base + run_sum)[seq_s] % n_align
    out = off.copy()
    out[order] = off_s
    return out


def gen_trace(
    name: str,
    n_requests: int,
    seed: int = 0,
    footprint_bytes: int = 128 << 20,
    hot_weight: float = 0.6,
    n_extents: int = 4,
    extent_kb: int = 256,
    burst_mean: float = 64.0,
    burst_speed: float = 64.0,
    seq_frac: float = 0.5,
    n_streams: int = 8,
) -> Dict[str, np.ndarray]:
    """Generate one synthetic trace in *byte* units (page-size agnostic).

    Arrivals use an ON/OFF burst process (deep-queue submission, like the
    originals): bursts of ~``burst_mean`` requests arrive ``burst_speed``×
    faster than the mean rate, separated by long gaps; the *overall mean*
    inter-arrival time equals Table 2's value exactly in expectation.
    """
    read_pct, avg_kb, avg_iat_us = WORKLOADS[name]
    rs = np.random.RandomState((zlib.crc32(name.encode()) & 0x7FFFFFFF) ^ seed)

    # arrivals: ON/OFF bursts with exact mean IAT
    m, s = burst_mean, burst_speed
    in_burst = rs.rand(n_requests) < (m - 1.0) / m
    iat_b = avg_iat_us / s
    iat_g = avg_iat_us * (m - (m - 1.0) / s)  # preserves the Table-2 mean
    iat = np.where(
        in_burst,
        rs.exponential(iat_b, n_requests),
        rs.exponential(iat_g, n_requests),
    )
    iat *= avg_iat_us / iat.mean()  # exact-mean correction (like sizes)
    arrival = np.cumsum(iat)

    # sizes: lognormal with target mean, 4KB-aligned, heavy tail
    sigma = 0.7
    mu = np.log(avg_kb * 1024) - sigma * sigma / 2
    size = rs.lognormal(mu, sigma, n_requests)
    size = np.maximum(_ALIGN, (size / _ALIGN).round() * _ALIGN)
    # exact-mean correction (keeps Table 2 average request size)
    size *= (avg_kb * 1024) / size.mean()
    size = np.maximum(_ALIGN, (size / _ALIGN).round() * _ALIGN).astype(np.int64)

    is_read = rs.rand(n_requests) < (read_pct / 100.0)

    # addresses: three-way mixture, calibrated to enterprise-trace structure:
    #   * hot refs target a handful of small contiguous *extents* (hot files,
    #     indexes, metadata — typically 100s of KB).  A small extent occupies many
    #     chips of few channels under die-first superpage layout, which is
    #     exactly the access pattern that serializes a shared-bus SSD while a
    #     path-diverse interconnect reaches all of the extent's chips at once;
    #   * sequential streams (scans / file reads) walk contiguous ranges;
    #   * the rest is uniform over the footprint.
    n_align = footprint_bytes // _ALIGN
    hot = rs.rand(n_requests) < hot_weight
    ext_pages = max(1, (extent_kb * 1024) // _ALIGN)
    ext_base = rs.randint(0, max(1, n_align - ext_pages), n_extents)
    # zipf-ish popularity over extents
    pop = 1.0 / np.arange(1, n_extents + 1)
    pop /= pop.sum()
    ext_of = rs.choice(n_extents, n_requests, p=pop)
    off_hot = ext_base[ext_of] + rs.randint(0, ext_pages, n_requests)
    off = np.where(hot, off_hot, rs.randint(0, n_align, n_requests)).astype(np.int64)
    sz_align = (size // _ALIGN).astype(np.int64)
    is_seq = (rs.rand(n_requests) < seq_frac) & ~hot
    stream_of = rs.randint(0, n_streams, n_requests)
    off = _seq_stream_offsets(off, sz_align, is_seq, stream_of, n_align)

    return {
        "name": name,
        "arrival_us": arrival,
        "is_read": is_read,
        "offset_bytes": off * _ALIGN,
        "size_bytes": size,
        "footprint_bytes": footprint_bytes,
    }


def mix_traces(name: str, n_requests_each: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Table 3 mixes: overlay constituents on a shared timeline with disjoint
    address ranges (separate tenants hitting one SSD).  Request counts are
    scaled per constituent so all spans align (faster tenants issue more).

    Emits per-request tenant attribution (``tenant`` = constituent index,
    ``tenant_names``) — pure metadata riding along the arrays.
    """
    names = MIXES.get(name, None)
    if names is None:  # ad-hoc mixes: "a+b" tenant lists beyond Table 3
        names = tuple(name.split("+"))
    span = n_requests_each * min(WORKLOADS[w][2] for w in names)
    parts = []
    for i, w in enumerate(names):
        cnt = max(50, int(span / WORKLOADS[w][2]))
        parts.append(gen_trace(w, cnt, seed + i))
    return overlay_traces(name, names, parts)


def overlay_traces(name: str, tenant_names, parts) -> Dict[str, np.ndarray]:
    """Overlay per-tenant byte traces on one timeline, disjoint addresses."""
    base = 0
    arrs, reads, offs, sizes, tens = [], [], [], [], []
    for t, p in enumerate(parts):
        arrs.append(p["arrival_us"])
        reads.append(p["is_read"])
        offs.append(p["offset_bytes"] + base)
        sizes.append(p["size_bytes"])
        tens.append(np.full(len(p["arrival_us"]), t, dtype=np.int32))
        base += p["footprint_bytes"]
    arrival = np.concatenate(arrs)
    order = np.argsort(arrival, kind="stable")
    return {
        "name": name,
        "arrival_us": arrival[order],
        "is_read": np.concatenate(reads)[order],
        "offset_bytes": np.concatenate(offs)[order],
        "size_bytes": np.concatenate(sizes)[order],
        "footprint_bytes": base,
        "tenant": np.concatenate(tens)[order],
        "tenant_names": tuple(tenant_names),
    }


def to_pages(trace: Dict[str, np.ndarray], page_bytes: int) -> Dict[str, np.ndarray]:
    """Convert a byte trace to page units for a given SSD config."""
    off = trace["offset_bytes"] // page_bytes
    last = (trace["offset_bytes"] + trace["size_bytes"] + page_bytes - 1) // page_bytes
    pages = {
        "arrival_us": trace["arrival_us"],
        "is_read": trace["is_read"],
        "offset_page": off.astype(np.int64),
        "n_pages": np.maximum(1, last - off).astype(np.int64),
        "footprint_pages": max(1, trace["footprint_bytes"] // page_bytes),
    }
    if "tenant" in trace:  # per-request attribution rides along untouched
        pages["tenant"] = np.asarray(trace["tenant"], np.int32)
        pages["tenant_names"] = tuple(trace.get(
            "tenant_names", [str(t) for t in
                             range(int(pages["tenant"].max()) + 1)]
        ))
    return pages


def trace_for(name: str, n_requests: int, seed: int = 0):
    """Workload or Table-3 mix by name."""
    if name in MIXES:
        per = max(1, n_requests // len(MIXES[name]))
        return mix_traces(name, per, seed)
    return gen_trace(name, n_requests, seed)


def default_n_requests(name: str, target_span_us: float = 300_000.0) -> int:
    """Pick a request count so every trace spans a comparable wall-clock
    window (sparse traces need fewer requests; int32 tick budget)."""
    if name in MIXES:
        iat = min(WORKLOADS[w][2] for w in MIXES[name]) / len(MIXES[name])
    else:
        iat = WORKLOADS[name][2]
    return int(np.clip(target_span_us / max(iat, 1e-9), 1500, 12000))
