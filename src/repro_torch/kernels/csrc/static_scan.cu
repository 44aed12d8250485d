// static_lane_scan — the statically-routed lane scan (baseline, pssd, pnssd,
// nossd, ideal) as one launch for every lane.
//
// Replaces the TPU kernel repro/kernels/batched_step.py:52 lane_tiled_step
// (one pallas_call per transaction around sim._make_batched_static_step,
// repro/ssd/sim.py:975-1066; flat twin sim.py:419-479).  On the TPU the scan
// loop stayed in JAX and every step was a kernel launch over a lane tile,
// with node tables pre-gathered and bit-packed for one-hot lookups.  Here
// one thread owns one lane and loops over its transactions in nominal
// order: the lane's plane free-at row and its three R_pad-wide resource
// arrays live in shared memory, and each candidate path is a short sorted
// list of resource ids (built by the wrapper from the combined masks), so a
// path schedule touches only the resources on the path.
//
// What bounds it: the scan is a chain of dependent steps (each transaction
// reads the state the previous one wrote), so its time is the chain's
// latency — a few hundred dependent integer operations per transaction —
// not memory traffic or arithmetic throughput.  Lanes are independent and
// run on separate SMs.
#include "common.cuh"

#define MAX_MASK 64  // longest candidate path (resources) the kernel takes
#define MAX_FC 64    // flash-controller section width the kernel takes

namespace {

struct Cand {
  int m;
  int idx[MAX_MASK];
  int fa[MAX_MASK], gs[MAX_MASK], ge[MAX_MASK];
  int done, wait, occ, hops;
  bool dead;
};

// Earliest common start >= e of a d-tick usage of every resource of the
// candidate; falls back to the masked free-at tail when the joint gap
// candidate does not fit everywhere (repro/ssd/sim.py:301-310).
__device__ int path_sched(const Cand& c, int e, int d) {
  int s1 = 0, tail = 0;
  for (int k = 0; k < c.m; ++k) {
    s1 = max(s1, gap_avail(c.gs[k], c.ge[k], c.fa[k], e, d));
    tail = max(tail, c.fa[k]);
  }
  s1 = max(s1, e);
  bool ok = true;
  for (int k = 0; k < c.m; ++k) ok = ok && !busy_at(c.fa[k], c.gs[k], c.ge[k], s1, d);
  return ok ? s1 : max(e, tail);
}

__device__ void commit_all(Cand& c, int s, int e2) {
  for (int k = 0; k < c.m; ++k) gap_commit(c.fa[k], c.gs[k], c.ge[k], s, e2);
}

// One candidate: phase 0 (command, + data for writes), the flash op, phase
// 1 (read data); commits land in the candidate's private copy of its
// resources and reach the lane state only if the candidate wins.
__device__ void eval_cand(Cand& c, const int* mlist, int M, const int* rfa, const int* rgs,
                          const int* rge, const uint8_t* dead_row, int hops, const int* sc,
                          bool is_read, int t0, int nbytes, int op, bool enable) {
  c.m = 0;
  c.dead = false;
  for (int k = 0; k < M; ++k) {
    int r = mlist[k];
    if (r < 0) break;
    c.idx[c.m] = r;
    c.fa[c.m] = rfa[r];
    c.gs[c.m] = rgs[r];
    c.ge[c.m] = rge[r];
    c.dead = c.dead || dead_row[r];
    ++c.m;
  }
  enable = enable && !c.dead;
  int ovh = sc[3], hop_ns = sc[7];
  int cmd = cmd_ticks(sc[4], hop_ns, hops);
  int xfer = xfer_ticks(sc[5], sc[6], hop_ns, nbytes, hops);
  int d0 = ovh + cmd + (is_read ? 0 : xfer);
  int s0 = path_sched(c, t0, d0);
  if (enable) commit_all(c, s0, s0 + d0);
  int op_end = s0 + d0 + op;
  int d1 = ovh + xfer;
  int s1 = path_sched(c, op_end, d1);
  if (enable && is_read) commit_all(c, s1, s1 + d1);
  c.done = is_read ? s1 + d1 : op_end;
  c.wait = (s0 - t0) + (is_read ? s1 - op_end : 0);
  c.occ = d0 + (is_read ? d1 : 0);
  c.hops = hops;
}

__global__ void static_lane_scan_kernel(
    const int* __restrict__ lanes, const int* __restrict__ scal, int n_scal,
    const int* __restrict__ mask_idx, int M, const int* __restrict__ hops_t,
    const uint8_t* __restrict__ cand2_t, const int* __restrict__ fc_fixed_t,
    const int* __restrict__ dist_t, const uint8_t* __restrict__ fc_valid_t,
    const uint8_t* __restrict__ res_dead_t, int F0, int N, int R,
    const int* __restrict__ txns, int T_total, int* plane_free, int P, int* res,
    int* __restrict__ out, int n_out) {
  extern __shared__ int smem[];
  int* pf = smem;
  int* rfa = pf + P;
  int* rgs = rfa + R;
  int* rge = rgs + R;
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < P; k += blockDim.x) pf[k] = plane_free[(size_t)b * P + k];
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    rfa[k] = res[((size_t)b * 3 + 0) * R + k];
    rgs[k] = res[((size_t)b * 3 + 1) * R + k];
    rge[k] = res[((size_t)b * 3 + 2) * R + k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tab = lanes[b * 4 + 0], off = lanes[b * 4 + 1];
    const int n = lanes[b * 4 + 2], oo = lanes[b * 4 + 3];
    const int* sc = scal + (size_t)tab * n_scal;
    const bool fc_nearest = sc[0] != 0, count_bus = sc[1] != 0, hold = sc[2] != 0;
    const int L0 = R - F0 - N;
    const int* dist = dist_t + (size_t)tab * F0 * N;
    const uint8_t* fc_valid = fc_valid_t + (size_t)tab * F0;
    const uint8_t* dead_row = res_dead_t + (size_t)tab * R;
    Cand A, B;
    int avail[MAX_FC];
    for (int i = 0; i < n; ++i) {
      const int g = off + i;
      const int arrival = txns[g], kind = txns[T_total + g];
      const int plane = txns[2 * T_total + g], node = txns[3 * T_total + g];
      const int nbytes = txns[4 * T_total + g], op = txns[5 * T_total + g];
      const bool is_read = kind == 0;
      const int tcand = max(arrival, pf[plane]);
      const int d_est = xfer_ticks(sc[5], sc[6], sc[7], nbytes, sc[8]) + sc[9] +
                        ((hold && is_read) ? op : 0);
      // nearest flash controller free now, else the earliest available
      // (first occurrence on ties, like argmin)
      bool any_free = false;
      int bd_i = 0, bd_v = 0, bt_i = 0, bt_v = 0;
      for (int f = 0; f < F0; ++f) {
        int r = L0 + f;
        int a = fc_valid[f] ? gap_avail(rgs[r], rge[r], rfa[r], tcand, d_est) : RT_BIG;
        avail[f] = a;
        bool fr = a <= tcand;
        any_free = any_free || fr;
        int dv = fr ? dist[f * N + node] : RT_BIG;
        if (f == 0 || dv < bd_v) { bd_v = dv; bd_i = f; }
        if (f == 0 || a < bt_v) { bt_v = a; bt_i = f; }
      }
      const int fc_near = any_free ? bd_i : bt_i;
      const int t0 = fc_nearest ? max(tcand, avail[fc_near]) : tcand;
      const int fcA = fc_nearest ? fc_near : fc_fixed_t[((size_t)tab * N + node) * 2 + 0];
      const int fcB = fc_nearest ? fc_near : fc_fixed_t[((size_t)tab * N + node) * 2 + 1];
      const bool cand2 = cand2_t[(size_t)tab * N + node] != 0;
      const size_t cA = (((size_t)tab * F0 + fcA) * N + node) * 2 + 0;
      const size_t cB = (((size_t)tab * F0 + fcB) * N + node) * 2 + 1;
      eval_cand(A, mask_idx + cA * M, M, rfa, rgs, rge, dead_row, hops_t[cA], sc, is_read, t0,
                nbytes, op, true);
      eval_cand(B, mask_idx + cB * M, M, rfa, rgs, rge, dead_row, hops_t[cB], sc, is_read, t0,
                nbytes, op, cand2);
      // the earlier finish wins, ties to A; a dead candidate never wins
      const bool useA = (A.dead ? RT_BIG : A.done) <= ((cand2 && !B.dead) ? B.done : RT_BIG);
      const bool failed = A.dead && (B.dead || !cand2);
      const Cand& c = useA ? A : B;
      for (int k = 0; k < c.m; ++k) {
        rfa[c.idx[k]] = c.fa[k];
        rgs[c.idx[k]] = c.gs[k];
        rge[c.idx[k]] = c.ge[k];
      }
      int done = c.done, wait = c.wait, occ = c.occ, hops_o = c.hops;
      if (failed) {
        done = tcand + RT_FAIL_TIMEOUT;
        wait = RT_FAIL_TIMEOUT;
        occ = 0;
        hops_o = 0;
      }
      pf[plane] = done;
      const int o = oo + i;
      out[0 * (size_t)n_out + o] = done;
      out[1 * (size_t)n_out + o] = wait;
      out[2 * (size_t)n_out + o] = wait > 0;
      out[3 * (size_t)n_out + o] = hops_o;
      out[4 * (size_t)n_out + o] = 1;
      out[5 * (size_t)n_out + o] = 0;
      out[6 * (size_t)n_out + o] = 0;
      out[7 * (size_t)n_out + o] = count_bus ? occ : 0;
      out[8 * (size_t)n_out + o] = count_bus ? 0 : hops_o * occ;
      out[9 * (size_t)n_out + o] = failed;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P; k += blockDim.x) plane_free[(size_t)b * P + k] = pf[k];
  for (int k = threadIdx.x; k < R; k += blockDim.x) {
    res[((size_t)b * 3 + 0) * R + k] = rfa[k];
    res[((size_t)b * 3 + 1) * R + k] = rgs[k];
    res[((size_t)b * 3 + 2) * R + k] = rge[k];
  }
}

}  // namespace

extern "C" int static_lane_scan_launch(
    const int* lanes, int B, const int* scal, int n_scal, const int* mask_idx, int M,
    const int* hops, const uint8_t* cand2, const int* fc_fixed, const int* dist,
    const uint8_t* fc_valid, const uint8_t* res_dead, int F0, int N, int R, const int* txns,
    int T_total, int* plane_free, int P, int* res, int* out, int n_out, void* stream) {
  if (M > MAX_MASK || F0 > MAX_FC) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  size_t smem = (size_t)(P + 3 * R) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(static_lane_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  static_lane_scan_kernel<<<B, 32, smem, (cudaStream_t)stream>>>(
      lanes, scal, n_scal, mask_idx, M, hops, cand2, fc_fixed, dist, fc_valid, res_dead, F0, N,
      R, txns, T_total, plane_free, P, res, out, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
