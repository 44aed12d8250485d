// Algorithm-1 scout kernels: scout_lane_scan (the scout-routed lane scan,
// one launch for every lane) and scout_step (one decision for a batch of
// scouts).  Both run the same decision, alg1_decide in common.cuh.
//
// Replace the TPU kernel repro/kernels/scout_step.py:219 scout_step_pallas
// (bodies :170-205 around step_math :68-167) together with the code that
// drove it: the DFS loop of repro/kernels/ops.py:40-157 and the retry loop of
// repro/ssd/sim.py:347-407.  On the TPU one pallas_call advanced a tile of
// scouts by one decision, every table lookup a one-hot matmul, and the DFS
// stack and the retry loop stayed in JAX around it.  Here one thread walks
// each lane's scout: the decision, the DFS (its stack of 4*n_nodes hops and
// its busy/tried bits in shared memory) and the retry at successive
// link-free events (at most 64 tries) are fused into the lane's step, and
// the per-lane link/FC/chip resource triples stay in shared memory for the
// whole scan.
//
// What bounds it: pointer chasing.  Each DFS step depends on the previous
// one and each transaction on the previous transaction's commits, so the
// time is the latency of that chain; the bytes moved and the operations
// done are far below what the card could serve in that time.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool bit_get(const uint32_t* w, int i) { return (w[i >> 5] >> (i & 31)) & 1u; }
__device__ __forceinline__ void bit_set(uint32_t* w, int i) { w[i >> 5] |= 1u << (i & 31); }
__device__ __forceinline__ void bit_clr(uint32_t* w, int i) { w[i >> 5] &= ~(1u << (i & 31)); }

// stack entry: node | (entry+1) << 16 | exit << 20 | misroute << 24
__device__ __forceinline__ int st_pack(int node, int entry, int exit, bool mis) {
  return node | ((entry + 1) << 16) | (exit << 20) | ((int)mis << 24);
}

struct Walk {
  bool success;
  int hops, steps, misroutes;
};

// One full DFS walk (repro/core/scout.py:78-196 semantics): push on
// advance, pop and free the link on backtrack, fail at an empty stack.  On
// return the stack holds the reserved path (``hops`` entries).
__device__ Walk dfs_walk(int src, int dst, uint32_t rng, bool allow, int cols, int N,
                         const int* __restrict__ port_link, const int* __restrict__ port_neighbor,
                         uint32_t* busy, uint32_t* tried, int* stack) {
  const int tw = (4 * N + 31) >> 5;
  for (int k = 0; k < tw; ++k) tried[k] = 0u;
  int cur = src, entry = -1, depth = 0, steps = 0;
  Walk w;
  w.success = false;
  while (true) {
    ++steps;
    bool free4[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      int l = port_link[cur * 4 + p];
      free4[p] = l >= 0 && !bit_get(busy, l) && !bit_get(tried, cur * 4 + p);
    }
    Decision d = alg1_decide(cur, dst, entry, rng, free4, allow, cols);
    rng = d.rng;
    if (d.at_dst) { w.success = true; break; }
    if (d.has_pick) {
      bit_set(busy, port_link[cur * 4 + d.pick]);
      bit_set(tried, cur * 4 + d.pick);
      stack[depth++] = st_pack(cur, entry, d.pick, d.is_mis);
      entry = (d.pick + 2) & 3;
      cur = port_neighbor[cur * 4 + d.pick];
    } else {
      if (depth == 0) break;
      int e = stack[--depth];
      int pnode = e & 0xFFFF, pexit = (e >> 20) & 0xF;
      bit_clr(busy, port_link[pnode * 4 + pexit]);
      cur = pnode;
      entry = ((e >> 16) & 0xF) - 1;
    }
  }
  w.hops = depth;
  w.steps = steps;
  int mis = 0;
  for (int k = 0; k < depth; ++k) mis += (stack[k] >> 24) & 1;
  w.misroutes = mis;
  return w;
}

__global__ void scout_lane_scan_kernel(
    const int* __restrict__ lanes, const int* __restrict__ scal, int n_scal,
    const int* __restrict__ dist_t, const uint8_t* __restrict__ fc_valid_t,
    const int* __restrict__ fc_node_t, const uint8_t* __restrict__ res_dead_t, int F0, int N,
    int R, const int* __restrict__ port_link, const int* __restrict__ port_neighbor, int cols,
    int hop_ns, const int* __restrict__ txns, int T_total, int* plane_free, int P, int* links,
    int L0, int* fcs, int NF, int* chips, int* rng_state, int* __restrict__ out, int n_out) {
  extern __shared__ int smem[];
  int* pf = smem;
  int* lfa = pf + P;
  int* lgs = lfa + L0;
  int* lge = lgs + L0;
  int* ffa = lge + L0;
  int* fgs = ffa + NF;
  int* fge = fgs + NF;
  int* cfa = fge + NF;
  int* cgs = cfa + N;
  int* cge = cgs + N;
  int* stack = cge + N;
  uint32_t* busy = (uint32_t*)(stack + 4 * N);
  uint32_t* tried = busy + ((L0 + 31) >> 5);
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < P; k += blockDim.x) pf[k] = plane_free[(size_t)b * P + k];
  for (int k = threadIdx.x; k < L0; k += blockDim.x) {
    lfa[k] = links[((size_t)b * 3 + 0) * L0 + k];
    lgs[k] = links[((size_t)b * 3 + 1) * L0 + k];
    lge[k] = links[((size_t)b * 3 + 2) * L0 + k];
  }
  for (int k = threadIdx.x; k < NF; k += blockDim.x) {
    ffa[k] = fcs[((size_t)b * 3 + 0) * NF + k];
    fgs[k] = fcs[((size_t)b * 3 + 1) * NF + k];
    fge[k] = fcs[((size_t)b * 3 + 2) * NF + k];
  }
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    cfa[k] = chips[((size_t)b * 3 + 0) * N + k];
    cgs[k] = chips[((size_t)b * 3 + 1) * N + k];
    cge[k] = chips[((size_t)b * 3 + 2) * N + k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tab = lanes[b * 4 + 0], off = lanes[b * 4 + 1];
    const int n = lanes[b * 4 + 2], oo = lanes[b * 4 + 3];
    const int* sc = scal + (size_t)tab * n_scal;
    const bool allow = sc[0] != 0, hold = sc[1] != 0;
    const int cmd_base = sc[4], xnum = sc[5], xden = sc[6], hns = sc[7];
    const int* dist = dist_t + (size_t)tab * F0 * N;
    const uint8_t* fc_valid = fc_valid_t + (size_t)tab * F0;
    const uint8_t* dead = res_dead_t + (size_t)tab * R;  // link section [0, L0)
    uint32_t rng = (uint32_t)rng_state[b];
    const int bw = (L0 + 31) >> 5;
    for (int i = 0; i < n; ++i) {
      const int g = off + i;
      const int arrival = txns[g], kind = txns[T_total + g];
      const int plane = txns[2 * T_total + g], node = txns[3 * T_total + g];
      const int nbytes = txns[4 * T_total + g], op = txns[5 * T_total + g];
      const bool is_read = kind == 0;
      const int tcand = max(arrival, pf[plane]);
      const int d_est = xfer_ticks(xnum, xden, hns, nbytes, sc[2]) + sc[3] +
                        ((hold && is_read) ? op : 0);
      // nearest FC free now, else the earliest available (§4.2)
      bool any_free = false;
      int bd_i = 0, bd_v = 0, bt_i = 0, bt_v = 0, bd_a = 0, bt_a = 0;
      for (int f = 0; f < NF; ++f) {
        int a = fc_valid[f] ? gap_avail(fgs[f], fge[f], ffa[f], tcand, d_est) : RT_BIG;
        bool fr = a <= tcand;
        any_free = any_free || fr;
        int dv = fr ? dist[f * N + node] : RT_BIG;
        if (f == 0 || dv < bd_v) { bd_v = dv; bd_i = f; bd_a = a; }
        if (f == 0 || a < bt_v) { bt_v = a; bt_i = f; bt_a = a; }
      }
      const int fc = any_free ? bd_i : bt_i;
      const int t0 = max(tcand, any_free ? bd_a : bt_a);
      const int src = fc_node_t[(size_t)tab * F0 + fc];
      const int cmd_pkt = cmd_ticks(cmd_base, hns, dist[fc * N + node]);
      // reads: command packet now, data-phase scout at tR completion
      const bool en_cmd = is_read && !hold;
      int s_cmd = t0;
      if (en_cmd) {
        s_cmd = gap_avail(fgs[fc], fge[fc], ffa[fc], t0, cmd_pkt);
        gap_commit(ffa[fc], fgs[fc], fge[fc], s_cmd, s_cmd + cmd_pkt);
      }
      const int ready_r = s_cmd + cmd_pkt + op;
      const int t_nonread = max(t0, gap_avail(cgs[node], cge[node], cfa[node], t0, d_est));
      const int t_read = max(max(ready_r, gap_avail(fgs[fc], fge[fc], ffa[fc], ready_r, d_est)),
                             gap_avail(cgs[node], cge[node], cfa[node], ready_r, d_est));
      const int t_xfer_req = is_read ? t_read : t_nonread;
      // scout at t, then at successive link-state events
      int t = hold ? t0 : t_xfer_req;
      int tries = 0;
      Walk w;
      while (true) {
        for (int k = 0; k < bw; ++k) busy[k] = 0u;
        for (int l = 0; l < L0; ++l)
          if (busy_at(lfa[l], lgs[l], lge[l], t, d_est) || dead[l]) bit_set(busy, l);
        rng = lcg_advance(rng);
        w = dfs_walk(src, node, rng, allow, cols, N, port_link, port_neighbor, busy, tried, stack);
        ++tries;
        if (w.success || tries >= RT_MAX_TRIES) break;
        int ev = RT_BIG, mx = lfa[0];
        for (int l = 0; l < L0; ++l) {
          if (lfa[l] > t) ev = min(ev, lfa[l]);
          if (lgs[l] > t) ev = min(ev, lgs[l]);
          mx = max(mx, lfa[l]);
        }
        t = (tries + 1 >= RT_MAX_TRIES) ? mx : max(ev, t + 1);
      }
      const int t_resv = t;
      const int hops = w.hops;
      const int start = t_resv + ceil_div_i((w.steps + hops) * hop_ns, RT_TICK_NS);
      const int cmd_v = cmd_ticks(cmd_base, hns, hops);
      const int xfer_v = xfer_ticks(xnum, xden, hns, nbytes, hops);
      const int end_p = start + (is_read ? xfer_v : cmd_v + xfer_v);
      int done, wait, commit_end;
      if (hold) {  // one circuit across CMD + flash op + transfer
        const int done_r = start + cmd_v + op + xfer_v;
        const int data_end_w = start + cmd_v + xfer_v;
        commit_end = is_read ? done_r : data_end_w;
        done = is_read ? done_r : data_end_w + op;
        wait = start - t0;
      } else {
        commit_end = end_p;
        done = is_read ? end_p : end_p + op;
        wait = (s_cmd - t0) + (start - t_xfer_req);
      }
      const bool fail = !w.success;
      if (fail) {
        done = tcand + RT_FAIL_TIMEOUT;
        wait = RT_FAIL_TIMEOUT;
      } else {  // commit the circuit: its links, the FC, the chip interface
        for (int k = 0; k < hops; ++k) {
          int e = stack[k];
          int l = port_link[(e & 0xFFFF) * 4 + ((e >> 20) & 0xF)];
          gap_commit(lfa[l], lgs[l], lge[l], t_resv, commit_end);
        }
        gap_commit(ffa[fc], fgs[fc], fge[fc], t_resv, commit_end);
        gap_commit(cfa[node], cgs[node], cge[node], t_resv, commit_end);
      }
      pf[plane] = done;
      const int o = oo + i;
      out[0 * (size_t)n_out + o] = done;
      out[1 * (size_t)n_out + o] = wait;
      out[2 * (size_t)n_out + o] = (tries > 1) || fail;
      out[3 * (size_t)n_out + o] = hops;
      out[4 * (size_t)n_out + o] = tries;
      out[5 * (size_t)n_out + o] = w.steps;
      out[6 * (size_t)n_out + o] = w.misroutes;
      out[7 * (size_t)n_out + o] = 0;
      out[8 * (size_t)n_out + o] = fail ? 0 : hops * (commit_end - t_resv);
      out[9 * (size_t)n_out + o] = fail;
    }
    rng_state[b] = (int)rng;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P; k += blockDim.x) plane_free[(size_t)b * P + k] = pf[k];
  for (int k = threadIdx.x; k < L0; k += blockDim.x) {
    links[((size_t)b * 3 + 0) * L0 + k] = lfa[k];
    links[((size_t)b * 3 + 1) * L0 + k] = lgs[k];
    links[((size_t)b * 3 + 2) * L0 + k] = lge[k];
  }
  for (int k = threadIdx.x; k < NF; k += blockDim.x) {
    fcs[((size_t)b * 3 + 0) * NF + k] = ffa[k];
    fcs[((size_t)b * 3 + 1) * NF + k] = fgs[k];
    fcs[((size_t)b * 3 + 2) * NF + k] = fge[k];
  }
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    chips[((size_t)b * 3 + 0) * N + k] = cfa[k];
    chips[((size_t)b * 3 + 1) * N + k] = cgs[k];
    chips[((size_t)b * 3 + 2) * N + k] = cge[k];
  }
}

// One decision per scout, the layout of scout_step_pallas: state [B, 8] =
// (cur, dst, entry, rng bits, flags, pick, misroute, link); busy [B, Lb] and
// tried [B, Tw] 0/1 maps, copied to the outputs with the taken port's bits set.
__global__ void scout_step_kernel(const int* __restrict__ state, const int* __restrict__ busy,
                                  int Lb, const int* __restrict__ tried, int Tw,
                                  const int* __restrict__ port_link,
                                  const int* __restrict__ port_neighbor, int cols, int allow,
                                  int B, int* __restrict__ state_out, int* __restrict__ busy_out,
                                  int* __restrict__ tried_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* st = state + (size_t)b * 8;
  const int cur = st[0], dst = st[1], entry = st[2];
  const int* brow = busy + (size_t)b * Lb;
  const int* trow = tried + (size_t)b * Tw;
  bool free4[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int l = port_link[cur * 4 + p];
    free4[p] = l >= 0 && brow[l] == 0 && trow[cur * 4 + p] == 0;
  }
  Decision d = alg1_decide(cur, dst, entry, (uint32_t)st[3], free4, allow != 0, cols);
  const int link = port_link[cur * 4 + d.pick];
  int* so = state_out + (size_t)b * 8;
  so[0] = d.has_pick ? port_neighbor[cur * 4 + d.pick] : cur;
  so[1] = dst;
  so[2] = d.has_pick ? (d.pick + 2) % 4 : entry;
  so[3] = (int)d.rng;
  so[4] = d.at_dst ? 2 : (d.has_pick ? 1 : 0);
  so[5] = d.has_pick ? d.pick : -1;
  so[6] = d.is_mis;
  so[7] = d.has_pick ? link : 0;
  int* bo = busy_out + (size_t)b * Lb;
  for (int k = 0; k < Lb; ++k) bo[k] = brow[k] != 0;
  int* to = tried_out + (size_t)b * Tw;
  for (int k = 0; k < Tw; ++k) to[k] = trow[k] != 0;
  if (d.has_pick) {
    bo[link] = 1;
    to[cur * 4 + d.pick] = 1;
  }
}

}  // namespace

extern "C" int scout_lane_scan_launch(
    const int* lanes, int B, const int* scal, int n_scal, const int* dist,
    const uint8_t* fc_valid, const int* fc_node, const uint8_t* res_dead, int F0, int N, int R,
    const int* port_link, const int* port_neighbor, int cols, int hop_ns, const int* txns,
    int T_total, int* plane_free, int P, int* links, int L0, int* fcs, int NF, int* chips,
    int* rng, int* out, int n_out, void* stream) {
  if (B == 0) return 0;
  size_t smem = (size_t)(P + 3 * L0 + 3 * NF + 3 * N + 4 * N) * sizeof(int) +
                (size_t)(((L0 + 31) >> 5) + ((4 * N + 31) >> 5)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(scout_lane_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scout_lane_scan_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      lanes, scal, n_scal, dist, fc_valid, fc_node, res_dead, F0, N, R, port_link, port_neighbor,
      cols, hop_ns, txns, T_total, plane_free, P, links, L0, fcs, NF, chips, rng, out, n_out);
  return (int)cudaGetLastError();
}

extern "C" int scout_step_launch(const int* state, const int* busy, int Lb, const int* tried,
                                 int Tw, const int* port_link, const int* port_neighbor, int cols,
                                 int allow, int B, int* state_out, int* busy_out, int* tried_out,
                                 void* stream) {
  if (B == 0) return 0;
  const int threads = 128;
  scout_step_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      state, busy, Lb, tried, Tw, port_link, port_neighbor, cols, allow, B, state_out, busy_out,
      tried_out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
