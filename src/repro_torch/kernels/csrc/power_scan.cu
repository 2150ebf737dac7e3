// The whole power_batch interval loop in one launch: one CTA per lane.
//
// Replaces: repro/kernels/step.py::fused_scan (the Pallas grid=(K,) scan
// with VMEM-resident state) for its one consumer, the power_batch step of
// repro/core/vec_power.py::_power_build, which runs it through the driver
// at repro/core/vec_engine.py::run_one.
//
// What bounds it on an H100: neither rate.  Per lane and interval it reads
// one trace value (and one [H] fault row when faulted) and does O(H)
// flops.  At the full power shape (1024 lanes, H = 800, K = 288) the
// function must move ~240 MB: the trace, cap/eff and the per-lane
// scalars, and the carry read once and written once.  The carry is 137 B
// a host (count, active, over_count, unserved and the [H, P-1] segment
// tables, P - 1 = 10); its initial value is an input of the function (the
// wrapper hands the kernel a copy of `init`), so it counts as read.  That
// is ~0.07 ms at 3.35 TB/s, and its ~2.4e9 f64 operations take less at
// the card's FP64 rate.  What it does pay for is
// the serial dependence between intervals: each interval needs several
// block-wide reductions (argmin picks, sums, any, max, a prefix sum), each
// a pair of __syncthreads, and the next interval depends on the result.
//
// Design: one 256-thread block per lane; threads stride over hosts, and
// every per-host quantity is owned by one thread for the whole run, so the
// [H] carry (count, active, over_count, unserved, plus cap, eff and the
// rank scratch: 37 bytes a host) sits in dynamic shared memory without
// locks, and the [H, P-1] segment tables stay in their global output rows,
// each touched only by its host's thread.  Threads talk only through the
// block reductions of reduce.cuh.  The K-interval loop runs inside the
// kernel, so there is one launch per chunk of lanes; lanes run in parallel
// across the SMs.
//
// Bit-exactness against the JAX reference (and through it the OO manager):
// the same ops in the same order — `(int)x` truncates and fmod(x, 1.0) is
// exact; seg_frac accumulates in interval order (adding 0.0 to the other
// segments, as the reference does, changes nothing and is skipped);
// unserved adds max(demand, cap) - cap; picks are first-occurrence
// argmin/argmax; and the file is built with -fmad=false so no multiply is
// contracted into an add.
#include <cmath>
#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;

// Ranks of the active hosts (inclusive prefix count - 1, in host order)
// into rank[]; returns the number of active hosts.  Owner mapping:
// host h belongs to thread h % blockDim.x, as everywhere in this file.
__device__ int active_ranks(const uint8_t* act, int* rank, int n_hosts,
                            int* scratch) {
  int carry = 0;
  for (int base = 0; base < n_hosts; base += blockDim.x) {
    const int h = base + threadIdx.x;
    const int a = (h < n_hosts && act[h]) ? 1 : 0;
    int total;
    const int incl = block_inclusive_scan(a, scratch, total);
    if (h < n_hosts) rank[h] = carry + incl - 1;
    carry += total;
  }
  return carry;
}

// _even_counts: the first V mod A active hosts take one extra VM.  Writes
// the new counts and returns the block-wide sum of max(new - old, 0).
__device__ int even_counts(const uint8_t* act, int* cnt, int* rank,
                           int n_hosts, int n_vms, int* scratch) {
  int a = active_ranks(act, rank, n_hosts, scratch);
  a = a > 1 ? a : 1;
  const int base = n_vms / a;
  const int rem = n_vms - base * a;
  int moved = 0;
  for (int h = threadIdx.x; h < n_hosts; h += blockDim.x) {
    const int nc = act[h] ? base + (rank[h] < rem ? 1 : 0) : 0;
    const int d = nc - cnt[h];
    moved += d > 0 ? d : 0;
    cnt[h] = nc;
  }
  return block_sum(moved, scratch);
}

__global__ void __launch_bounds__(kThreads) power_scan_kernel(
    const double* __restrict__ trace, const double* __restrict__ cap,
    const double* __restrict__ eff, const double* __restrict__ up_thr,
    const double* __restrict__ lo_thr, const double* __restrict__ vm_mips,
    const int* __restrict__ cooldown_k, const uint8_t* __restrict__ fail_tbl,
    int* __restrict__ count, uint8_t* __restrict__ active,
    int* __restrict__ cooldown, int* __restrict__ seg_count,
    double* __restrict__ seg_frac, int* __restrict__ over_count,
    double* __restrict__ unserved, int* __restrict__ migrations,
    int* __restrict__ scale_out, int* __restrict__ scale_in, int n_hosts,
    int n_points, int n_intervals, int n_vms, int min_active) {
  extern __shared__ double smem[];
  __shared__ double red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_n[32];
  const int H = n_hosts, S = n_points - 1;
  double* s_cap = smem;
  double* s_eff = s_cap + H;
  double* s_uns = s_eff + H;
  int* s_cnt = reinterpret_cast<int*>(s_uns + H);
  int* s_over = s_cnt + H;
  int* s_rank = s_over + H;
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_rank + H);

  const long long lane = blockIdx.x;
  const long long lh = lane * H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    s_cap[h] = cap[lh + h];
    s_eff[h] = eff[lh + h];
    s_uns[h] = unserved[lh + h];
    s_cnt[h] = count[lh + h];
    s_over[h] = over_count[lh + h];
    s_act[h] = active[lh + h];
  }
  int* segc = seg_count + lh * S;
  double* segf = seg_frac + lh * S;
  int cool = cooldown[lane], migr = migrations[lane];
  int n_out = scale_out[lane], n_in = scale_in[lane];
  const double up = up_thr[lane], lo = lo_thr[lane], vmm = vm_mips[lane];
  const int cool_k = cooldown_k[lane];
  const double inf = INFINITY;
  const double top = static_cast<double>(S);

  for (int k = 0; k < n_intervals; ++k) {
    const uint8_t* failed =
        fail_tbl ? fail_tbl + (lane * n_intervals + k) * H : nullptr;
    int avail = H, fmoved = 0;
    if (failed) {
      // Host crashes at the start of the interval (keep-alive election).
      double kv = inf;
      int ki = INT_MAX, any_act = 0, n_free = 0;
      for (int h = threadIdx.x; h < H; h += blockDim.x) {
        if (!failed[h]) {
          ++n_free;
          if (s_eff[h] < kv) {
            kv = s_eff[h];
            ki = h;
          }
          if (s_act[h]) any_act = 1;
        }
      }
      block_argmin(kv, ki, red_v, red_i);
      const int keep = ki == INT_MAX ? 0 : ki;
      any_act = __syncthreads_or(any_act);
      avail = block_sum(n_free, red_n);
      int changed = 0;
      for (int h = threadIdx.x; h < H; h += blockDim.x) {
        const uint8_t a =
            (s_act[h] && !failed[h]) || (!any_act && h == keep) ? 1 : 0;
        changed |= a != s_act[h];
        s_act[h] = a;
      }
      if (__syncthreads_or(changed))
        fmoved = even_counts(s_act, s_cnt, s_rank, H, n_vms, red_n);
    }

    // Demand, utilization, energy segments, SLA for the current placement.
    const double d = trace[lane * n_intervals + k] * vmm;
    int n_act = 0, any_over = 0;
    double umax = -inf, on_v = inf, off_v = inf;
    int on_i = INT_MAX, off_i = INT_MAX;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      const double c = s_cap[h];
      const double demand = static_cast<double>(s_cnt[h]) * d;
      const double q = demand / c;
      const double util = q < 1.0 ? q : 1.0;
      const double x = util * top;
      int sg = static_cast<int>(x);
      sg = sg < S - 1 ? sg : S - 1;
      const double frac = x >= top ? 1.0 : fmod(x, 1.0);
      const bool a = s_act[h];
      if (a) {
        segc[h * S + sg] += 1;
        segf[h * S + sg] += frac;
        ++n_act;
        if (util > up) any_over = 1;
        umax = util > umax ? util : umax;
        const double ne = -s_eff[h];
        if (ne < off_v) {
          off_v = ne;
          off_i = h;
        }
      } else if (!(failed && failed[h]) && s_eff[h] < on_v) {
        on_v = s_eff[h];
        on_i = h;
      }
      if (demand > c) s_over[h] += 1;
      s_uns[h] = s_uns[h] + ((demand > c ? demand : c) - c);
    }
    n_act = block_sum(n_act, red_n);
    any_over = __syncthreads_or(any_over);
    umax = block_max(umax, -inf, red_v);
    block_argmin(on_v, on_i, red_v, red_i);
    block_argmin(off_v, off_i, red_v, red_i);

    // Autoscale decision at the end of the interval.
    const bool can = cool == 0;
    const bool want_out = can && any_over && n_act < avail;
    const bool want_in =
        can && !want_out && umax < lo && n_act > min_active;
    if (want_out || want_in) {
      const int pick = want_out ? (on_i == INT_MAX ? 0 : on_i)
                                : (off_i == INT_MAX ? 0 : off_i);
      if (pick % blockDim.x == threadIdx.x && pick < H)
        s_act[pick] = want_out ? 1 : 0;
      migr += even_counts(s_act, s_cnt, s_rank, H, n_vms, red_n);
      cool = cool_k;
    } else {
      cool = cool > 0 ? cool - 1 : 0;
    }
    migr += fmoved;
    n_out += want_out ? 1 : 0;
    n_in += want_in ? 1 : 0;
  }

  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    unserved[lh + h] = s_uns[h];
    count[lh + h] = s_cnt[h];
    over_count[lh + h] = s_over[h];
    active[lh + h] = s_act[h];
  }
  if (threadIdx.x == 0) {
    cooldown[lane] = cool;
    migrations[lane] = migr;
    scale_out[lane] = n_out;
    scale_in[lane] = n_in;
  }
}

}  // namespace

extern "C" int power_scan_f64(
    const void* trace, const void* cap, const void* eff, const void* up_thr,
    const void* lo_thr, const void* vm_mips, const void* cooldown_k,
    const void* fail_tbl, void* count, void* active, void* cooldown,
    void* seg_count, void* seg_frac, void* over_count, void* unserved,
    void* migrations, void* scale_out, void* scale_in, int lanes,
    int n_hosts, int n_points, int n_intervals, int n_vms, int min_active,
    void* stream) {
  const size_t smem = static_cast<size_t>(n_hosts) * 37;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        power_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  power_scan_kernel<<<lanes, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(trace), static_cast<const double*>(cap),
      static_cast<const double*>(eff), static_cast<const double*>(up_thr),
      static_cast<const double*>(lo_thr),
      static_cast<const double*>(vm_mips),
      static_cast<const int*>(cooldown_k),
      static_cast<const uint8_t*>(fail_tbl), static_cast<int*>(count),
      static_cast<uint8_t*>(active), static_cast<int*>(cooldown),
      static_cast<int*>(seg_count), static_cast<double*>(seg_frac),
      static_cast<int*>(over_count), static_cast<double*>(unserved),
      static_cast<int*>(migrations), static_cast<int*>(scale_out),
      static_cast<int*>(scale_in), n_hosts, n_points, n_intervals, n_vms,
      min_active);
  return static_cast<int>(cudaGetLastError());
}
