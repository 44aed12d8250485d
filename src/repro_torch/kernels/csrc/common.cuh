// Shared device code of the lane-scan kernels: the single-gap resource
// primitives, the integer timing formulas and Algorithm 1's decision.
//
// Every time-shared resource (bus, mesh link, flash controller, chip I/O
// interface) is a triple (free_at, gap_start, gap_end): busy through free_at
// except one remembered idle gap.  All arithmetic is int32 ticks exactly as
// in the JAX reference (repro/ssd/sim.py:164-246); the scout rng is uint32.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define RT_BIG (1 << 30)
#define RT_FAIL_TIMEOUT (1 << 20)
#define RT_MAX_TRIES 64
#define RT_TICK_NS 10
#define RT_N_OUT 10

__device__ __forceinline__ int ceil_div_i(int a, int b) { return (a + b - 1) / b; }

// Earliest start >= e where a d-tick usage fits (the gap, else the tail).
__device__ __forceinline__ int gap_avail(int gs, int ge, int fa, int e, int d) {
  int s_gap = max(e, gs);
  return (s_gap + d <= ge) ? s_gap : max(e, fa);
}

// True when the resource cannot host a d-tick usage starting exactly at t.
__device__ __forceinline__ bool busy_at(int fa, int gs, int ge, int t, int d) {
  return !((t >= fa) || ((t >= gs) && (t + d <= ge)));
}

// Carve [s, e2) out of the resource; remember the larger leftover gap.
__device__ __forceinline__ void gap_commit(int& fa, int& gs, int& ge, int s, int e2) {
  if (s >= gs && e2 <= ge) {  // inside the gap: keep the larger side
    if ((s - gs) >= (ge - e2)) ge = s; else gs = e2;
  } else {  // at/after free_at: keep the larger of (old gap, new idle span)
    int sfa = max(s, fa);
    if ((ge - gs) < (sfa - fa)) { gs = fa; ge = sfa; }
    fa = max(fa, e2);
  }
}

__device__ __forceinline__ int cmd_ticks(int cmd_base_ns, int hop_ns, int hops) {
  return max(ceil_div_i(cmd_base_ns + hops * hop_ns, RT_TICK_NS), 1);
}

__device__ __forceinline__ int xfer_ticks(int num, int den, int hop_ns, int nbytes, int hops) {
  return ceil_div_i(ceil_div_i(nbytes * num, den) + hops * hop_ns, RT_TICK_NS);
}

__device__ __forceinline__ uint32_t xorshift32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

__device__ __forceinline__ uint32_t lcg_advance(uint32_t x) {
  return (x * 747796405u + 2891336453u) | 1u;
}

struct Decision {
  bool at_dst;
  bool has_pick;
  bool is_mis;
  int pick;
  uint32_t rng;
};

// Algorithm 1, one decision: prefer a free minimal port (X then Y), else —
// if allowed — any free port other than the entry port, else backtrack.
// Ties are broken by one xorshift32 draw and an unsigned modulo; the
// candidate order is [minimal X, minimal Y] or [RIGHT, UP, LEFT, DOWN].
__device__ __forceinline__ Decision alg1_decide(int cur, int dst, int entry, uint32_t rng,
                                                const bool free4[4], bool allow, int cols) {
  Decision d;
  d.at_dst = cur == dst;
  int diffx = dst % cols - cur % cols;
  int diffy = dst / cols - cur / cols;
  int px = diffx > 0 ? 0 : (diffx < 0 ? 2 : -1);
  int py = diffy > 0 ? 1 : (diffy < 0 ? 3 : -1);
  bool fx = px >= 0 && free4[px];
  bool fy = py >= 0 && free4[py];
  int n_min = (int)fx + (int)fy;
  bool fmis[4];
  int n_mis = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    fmis[p] = free4[p] && p != entry && allow;
    n_mis += (int)fmis[p];
  }
  bool use_min = n_min > 0;
  int count = use_min ? n_min : n_mis;
  uint32_t r = (!d.at_dst && count > 1) ? xorshift32(rng) : rng;
  int idx = (int)(r % (uint32_t)max(count, 1));
  int pick = 0, seen = 0;
  if (use_min) {
    if (fx) { if (seen == idx) pick = px; ++seen; }
    if (fy) { if (seen == idx) pick = py; ++seen; }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (fmis[p]) { if (seen == idx) pick = p; ++seen; }
  }
  d.has_pick = count > 0 && !d.at_dst;
  d.is_mis = d.has_pick && !use_min;
  d.pick = pick;
  d.rng = r;
  return d;
}
