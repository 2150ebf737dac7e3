// The whole fleet_batch while-loop in one launch: one CTA per lane.
//
// Replaces: repro/kernels/step.py::fused_step_body (the Pallas call that
// ran one iteration of the fleet while_loop per invocation, the cond
// outside) for its one consumer, the fleet step of
// repro/core/vec_cluster.py::_fleet_build, which the driver at
// repro/core/vec_engine.py::run_one ran under lax.while_loop.  Here the
// cond is inside: each block loops `while (cond && it < max_iters)` and
// writes its lane's final carry and iteration count, so a chunk of lanes
// is one launch and no host sync per iteration.
//
// What bounds it on an H100: neither rate.  Per lane and iteration it
// reads each node's K failure rounds and k_degrade degradation times
// (L1/L2-resident after the first iteration) and does O(n) arithmetic and
// one O(n^2) rank selection for the median; the bytes the function must
// move (tables in, carry in and out) take well under a millisecond at
// 3.35 TB/s.  What it pays for is the serial chain within an iteration:
// two block reductions, a block prefix scan, a block max and min, the
// median's selection and an argmax, each a pair of __syncthreads, and the
// next iteration depends on the result.  Lanes run in parallel across
// SMs, so a chunk takes as long as its longest lane.
//
// Design: one 512-thread block per lane; threads stride over the
// n = n_nodes + n_spares nodes, and node i belongs to thread i % blockDim
// for the whole run, so the per-node carry (bias, slow_count,
// evict_until, was_up, was_active) and the per-iteration scratch (the
// slowdown keys, next failure, degradation multiplier, up/active flags)
// sit in dynamic shared memory without locks: 49 bytes a node in f64,
// 29 in f32.  fail_start [n, K] and degrade_t [n, k_degrade] stay in their
// global rows, each row read only by its node's thread.  Fault windows are
// per-lane rows; each thread scans them for its own nodes.  The median of
// the active slowdowns is found by rank selection: each active node counts
// the active nodes below it (ties broken by index), and the nodes of rank
// lo and hi are the lo-th and hi-th order statistics, the values
// sort(...)[lo/hi] gives.
//
// Bit-exactness against the plain version (kernels/fleet_step.py) on the
// card: the same operations in the same order, built with -fmad=false;
// transcendentals (exp, log, cos) through the CUDA math library, as
// torch's CUDA kernels do; u^e as exp(log(u)·e); the random stream is
// kernels/fleet_rng.py's Philox4x32-10, Box–Muller and AS241, word for
// word.
#include <cmath>
#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 512;
constexpr uint32_t kStreamJitter = 0, kStreamMax = 1, kStreamEvict = 2;
constexpr double kStallRetryS = 60.0;
constexpr double kUniformMin = 1e-12;
constexpr double kTwoPi = 6.283185307179586;

struct Words {
  uint32_t w0, w1, w2, w3;
};

// Philox4x32-10: counter (c0, c1, 0, 0), key (k0, k1).
__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1,
                                        uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return {c0, c1, c2, c3};
}

__device__ __forceinline__ float uniform24(uint32_t w) {
  return static_cast<float>((w >> 8) + 1u) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ uint64_t bits53(uint32_t w0, uint32_t w1) {
  return (static_cast<uint64_t>(w0 >> 5) << 26) + (w1 >> 6);
}

__device__ __forceinline__ double uniform53(uint32_t w0, uint32_t w1) {
  return static_cast<double>(bits53(w0, w1) + 1u) * 1.1102230246251565e-16;
}

__device__ __forceinline__ float normal_f32(uint32_t w0, uint32_t w1) {
  const float u1 = uniform24(w0), u2 = uniform24(w1);
  return sqrtf(logf(u1) * -2.0f) * cosf(u2 * static_cast<float>(kTwoPi));
}

__device__ __forceinline__ double normal_f64(const Words& w) {
  const double u1 = uniform53(w.w0, w.w1), u2 = uniform53(w.w2, w.w3);
  return sqrt(log(u1) * -2.0) * cos(u2 * kTwoPi);
}

// Uniform in [1e-12, 1), as jax.random.uniform(minval=1e-12) forms it.
template <typename T>
__device__ __forceinline__ T uniform_min(uint32_t w0, uint32_t w1);

template <>
__device__ __forceinline__ float uniform_min<float>(uint32_t w0, uint32_t) {
  const float u = static_cast<float>(w0 >> 8) * 5.9604644775390625e-08f;
  const float v = u * static_cast<float>(1.0 - kUniformMin) +
                  static_cast<float>(kUniformMin);
  return v > static_cast<float>(kUniformMin) ? v
                                             : static_cast<float>(kUniformMin);
}

template <>
__device__ __forceinline__ double uniform_min<double>(uint32_t w0,
                                                      uint32_t w1) {
  const double u = static_cast<double>(bits53(w0, w1)) *
                   1.1102230246251565e-16;
  const double v = u * (1.0 - kUniformMin) + kUniformMin;
  return v > kUniformMin ? v : kUniformMin;
}

// ((c7·r + c6)·r + …)·r + c0, one multiply and one add a term.
template <typename T>
__device__ __forceinline__ T horner(const double (&c)[8], T r) {
  T acc = r * static_cast<T>(c[7]) + static_cast<T>(c[6]);
#pragma unroll
  for (int k = 5; k >= 0; --k) acc = acc * r + static_cast<T>(c[k]);
  return acc;
}

// AS241 (Wichura 1988), PPND16.
__device__ const double kA[8] = {
    3.3871328727963666080e0, 1.3314166789178437745e+2,
    1.9715909503065514427e+3, 1.3731693765509461125e+4,
    4.5921953931549871457e+4, 6.7265770927008700853e+4,
    3.3430575583588128105e+4, 2.5090809287301226727e+3};
__device__ const double kB[8] = {
    1.0, 4.2313330701600911252e+1, 6.8718700749205790830e+2,
    5.3941960214247511077e+3, 2.1213794301586595867e+4,
    3.9307895800092710610e+4, 2.8729085735721942674e+4,
    5.2264952788528545610e+3};
__device__ const double kC[8] = {
    1.42343711074968357734e0, 4.63033784615654529590e0,
    5.76949722146069140550e0, 3.64784832476320460504e0,
    1.27045825245236838258e0, 2.41780725177450611770e-1,
    2.27238449892691845833e-2, 7.74545014278341407640e-4};
__device__ const double kD[8] = {
    1.0, 2.05319162663775882187e0, 1.67638483018380384940e0,
    6.89767334985100004550e-1, 1.48103976427480074590e-1,
    1.51986665636164571966e-2, 5.47593808499534494600e-4,
    1.05075007164441684324e-9};
__device__ const double kE[8] = {
    6.65790464350110377720e0, 5.46378491116411436990e0,
    1.78482653991729133580e0, 2.96560571828504891230e-1,
    2.65321895265761230930e-2, 1.24266094738807843860e-3,
    2.71155556874348757815e-5, 2.01033439929228813265e-7};
__device__ const double kF[8] = {
    1.0, 5.99832206555887937690e-1, 1.36929880922735805310e-1,
    1.48753612908506148525e-2, 7.86869131145613259100e-4,
    1.84631831751005468180e-5, 1.42151175831644588870e-7,
    2.04426310338993978564e-15};

template <typename T>
__device__ T ndtri(T p) {
  const T inf = static_cast<T>(INFINITY);
  if (p <= T(0)) return -inf;
  if (p >= T(1)) return inf;
  const T q = p - static_cast<T>(0.5);
  const T aq = q < T(0) ? -q : q;
  if (aq <= static_cast<T>(0.425)) {
    const T r = static_cast<T>(0.180625) - q * q;
    return q * horner(kA, r) / horner(kB, r);
  }
  const T r = sqrt(-log(q < T(0) ? p : T(1) - p));
  T v;
  if (r <= static_cast<T>(5.0)) {
    const T x = r - static_cast<T>(1.6);
    v = horner(kC, x) / horner(kD, x);
  } else {
    const T x = r - static_cast<T>(5.0);
    v = horner(kE, x) / horner(kF, x);
  }
  return q < T(0) ? -v : v;
}

// Order-preserving integer view of a non-negative float (the slowdowns).
__device__ __forceinline__ long long key_bits(double v) {
  return __double_as_longlong(v);
}
__device__ __forceinline__ int key_bits(float v) { return __float_as_int(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) fleet_loop_kernel(
    const T* __restrict__ base_step_s, const T* __restrict__ repair_s,
    const int* __restrict__ ckpt_every, const T* __restrict__ ckpt_write_s,
    const T* __restrict__ restart_s, const T* __restrict__ sigma,
    const T* __restrict__ evict_factor, const T* __restrict__ degrade_factor,
    const T* __restrict__ min_nodes, const int* __restrict__ total_steps,
    const T* __restrict__ max_wall_s, const T* __restrict__ fail_start,
    const long long* __restrict__ seed, const T* __restrict__ degrade_t,
    const int* __restrict__ fault_node, const T* __restrict__ fault_start,
    const T* __restrict__ fault_end, T* __restrict__ t_io,
    int* __restrict__ step_io, int* __restrict__ last_io,
    T* __restrict__ bias_io, int* __restrict__ slow_io,
    T* __restrict__ evict_io, uint8_t* __restrict__ wasup_io,
    uint8_t* __restrict__ wasact_io, T* __restrict__ watch_io,
    int* __restrict__ failures_io, int* __restrict__ restarts_io,
    int* __restrict__ evictions_io, T* __restrict__ lost_io,
    T* __restrict__ stall_io, T* __restrict__ ckpt_io,
    int* __restrict__ it_out, int n_nodes, int n, int K, int KD, int window,
    int W, int track, int degrade, int sigma_zero, int max_iters) {
  extern __shared__ double smem[];
  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ int red_n[32];
  __shared__ T s_med[2];
  T* s_bias = reinterpret_cast<T*>(smem);
  T* s_evict = s_bias + n;
  T* s_key = s_evict + n;   // slowdown of an active node, +inf elsewhere
  T* s_next = s_key + n;    // next schedule failure strictly after now
  T* s_deg = s_next + n;    // degradation multiplier
  int* s_cnt = reinterpret_cast<int*>(s_deg + n);
  uint8_t* s_wasup = reinterpret_cast<uint8_t*>(s_cnt + n);
  uint8_t* s_wasact = s_wasup + n;
  uint8_t* s_ups = s_wasact + n;  // schedule-up now
  uint8_t* s_up = s_ups + n;      // schedule-up and not evicted
  uint8_t* s_act = s_up + n;      // active now

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x;
  const long long ln = lane * n;
  const T inf = static_cast<T>(INFINITY);
  const T base = base_step_s[lane], rep = repair_s[lane];
  const T ckw = ckpt_write_s[lane], rst = restart_s[lane];
  const T sig = sigma[lane], ef = evict_factor[lane], mn = min_nodes[lane];
  const T maxw = max_wall_s[lane];
  const int every = ckpt_every[lane], total = total_steps[lane];
  const uint32_t key0 = static_cast<uint32_t>(seed[lane] & 0xFFFFFFFFLL);
  const T log_df = degrade ? log(degrade_factor[lane]) : T(0);
  const T half = sig / T(2);
  const T sig_tot = sqrt(sig * sig + half * half);
  const bool per_node = track || degrade;
  const T* fs_lane = fail_start + ln * K;
  const T* dg_lane = degrade ? degrade_t + ln * KD : nullptr;
  const int* fnode = W ? fault_node + lane * W : nullptr;
  const T* fstart = W ? fault_start + lane * W : nullptr;
  const T* fend = W ? fault_end + lane * W : nullptr;

  for (int i = tid; i < n; i += nt) {
    s_bias[i] = bias_io[ln + i];
    s_evict[i] = evict_io[ln + i];
    s_cnt[i] = slow_io[ln + i];
    s_wasup[i] = wasup_io[ln + i];
    s_wasact[i] = wasact_io[ln + i];
  }
  T t = t_io[lane], watch = watch_io[lane];
  T lost = lost_io[lane], stall = stall_io[lane], ckpt = ckpt_io[lane];
  int step = step_io[lane], last = last_io[lane];
  int failures = failures_io[lane], restarts = restarts_io[lane];
  int evictions = evictions_io[lane];
  int it = 0;
  __syncthreads();

  while (it < max_iters && step < total && t < maxw) {
    // -- schedule state, failures, next failure, cascade window ----------
    int nfail = 0;
    T fwin = inf;
    for (int i = tid; i < n; i += nt) {
      const T* row = fs_lane + static_cast<long long>(i) * K;
      int ended = 0;
      for (int k = 0; k < K; ++k) ended += (row[k] + rep <= t) ? 1 : 0;
      const int r = ended < K - 1 ? ended : K - 1;
      const T cur = row[r];
      const bool rdown = cur <= t && t < cur + rep;
      bool down = rdown;
      T nf = cur > t ? cur : ((rdown && r < K - 1) ? row[r + 1] : inf);
      for (int w = 0; w < W; ++w) {
        if (fnode[w] != i) continue;
        const T s0 = fstart[w];
        if (s0 <= t && t < fend[w]) down = true;
        if (s0 > t && s0 < nf) nf = s0;
      }
      const bool ups = !down;
      const bool up = track ? (ups && t >= s_evict[i]) : ups;
      if (s_wasup[i] && !ups) ++nfail;
      if (s_wasact[i] && cur > watch && cur <= t && cur < fwin) fwin = cur;
      s_next[i] = nf;
      s_ups[i] = ups;
      s_up[i] = up;
    }
    for (int w = tid; w < W; w += nt) {
      const T s0 = fstart[w];
      if (s_wasact[fnode[w]] && s0 > watch && s0 <= t && s0 < fwin) fwin = s0;
    }
    failures += block_sum(nfail, red_n);
    fwin = block_min(fwin, inf, red_v);
    const bool cascade = watch > -inf && watch < inf && fwin < t;

    // -- active set: index-ordered prefix of up nodes, capped at n_nodes -
    int n_up = 0;
    for (int b0 = 0; b0 < n; b0 += nt) {
      const int i = b0 + tid;
      const int a = (i < n && s_up[i]) ? 1 : 0;
      int tot;
      const int incl = block_inclusive_scan(a, red_n, tot);
      if (i < n) s_act[i] = (a && n_up + incl <= n_nodes) ? 1 : 0;
      n_up += tot;
    }
    const int n_active = n_up < n_nodes ? n_up : n_nodes;
    const bool stalled = !cascade && static_cast<T>(n_active) < mn;
    const int n_one = n_active > 1 ? n_active : 1;

    // -- straggler sampling and the earliest active failure -------------
    T max_slow, tint = inf;
    if (per_node) {
      T ms = -inf;
      for (int i = tid; i < n; i += nt) {
        T sd = s_bias[i];
        if (degrade) {
          const T* drow = dg_lane + static_cast<long long>(i) * KD;
          int c = 0;
          for (int k = 0; k < KD; ++k) c += drow[k] <= t ? 1 : 0;
          const T dm = exp(static_cast<T>(c) * log_df);
          s_deg[i] = dm;
          sd = sd * dm;
        }
        if (!sigma_zero) {
          const Words w = philox(static_cast<uint32_t>(it),
                                 static_cast<uint32_t>(i), key0,
                                 kStreamJitter);
          const float z = normal_f32(w.w0, w.w1);
          sd = sd * exp(static_cast<T>(z) * sig);
        }
        const bool a = s_act[i];
        s_key[i] = a ? sd : inf;
        if (a) {
          if (sd > ms) ms = sd;
          if (s_next[i] < tint) tint = s_next[i];
        }
      }
      max_slow = block_max(ms, -inf, red_v);
    } else {
      for (int i = tid; i < n; i += nt)
        if (s_act[i] && s_next[i] < tint) tint = s_next[i];
      if (sigma_zero) {
        max_slow = T(1);
      } else {
        // Only the max matters: sample it by inverse CDF.
        const Words w = philox(static_cast<uint32_t>(it), 0u, key0,
                               kStreamMax);
        const T u = uniform_min<T>(w.w0, w.w1);
        const T e = static_cast<T>(1.0 / static_cast<double>(n_one));
        max_slow = exp(sig_tot * ndtri(exp(log(u) * e)));
      }
    }
    tint = block_min(tint, inf, red_v);
    const T wq = static_cast<T>(n_nodes) / static_cast<T>(n_one);
    const T width = wq > T(1) ? wq : T(1);
    const T step_s = base * max_slow * width;
    const bool go = !cascade && !stalled;
    const bool interrupted = go && tint < t + step_s;
    const bool completed = go && !interrupted;
    const T t_done = t + step_s;
    const int step1 = step + 1;

    // -- median, chronic stragglers, eviction ----------------------------
    bool evict_now = false;
    if (track) {
      // floor((n_active - 1) / 2) clamped at 0; n_active / 2 is >= 0.
      const int lo = n_active >= 1 ? (n_active - 1) / 2 : 0;
      const int hi = n_active / 2;
      if (tid == 0) {
        s_med[0] = inf;
        s_med[1] = inf;
      }
      __syncthreads();
      for (int i = tid; i < n; i += nt) {
        if (!s_act[i]) continue;
        const T vi = s_key[i];
        const auto ki = key_bits(vi);
        int rank = 0;
        for (int j = 0; j < n; ++j) {
          const auto kj = key_bits(s_key[j]);
          rank += (kj < ki || (kj == ki && j < i)) ? 1 : 0;
        }
        if (rank == lo) s_med[0] = vi;
        if (rank == hi) s_med[1] = vi;
      }
      __syncthreads();
      const T med = static_cast<T>(0.5) * (s_med[0] + s_med[1]);
      const T thr = ef * med;
      int any_chronic = 0;
      T bv = inf;
      int bi = INT_MAX;
      for (int i = tid; i < n; i += nt) {
        const bool a = s_act[i];
        const int sc1 = a ? (s_key[i] > thr ? s_cnt[i] + 1 : 0) : s_cnt[i];
        if (a && sc1 >= window) {
          any_chronic = 1;
          const T v = -(degrade ? s_bias[i] * s_deg[i] : s_bias[i]);
          if (v < bv) {
            bv = v;
            bi = i;
          }
        }
      }
      any_chronic = __syncthreads_or(any_chronic);
      block_argmin(bv, bi, red_v, red_i);
      const int worst = bi == INT_MAX ? 0 : bi;
      evict_now = completed && any_chronic;
      T new_bias = T(0);
      if (evict_now) {
        const Words w = philox(static_cast<uint32_t>(it), 0u, key0,
                               kStreamEvict);
        new_bias = static_cast<T>(
            exp(normal_f64(w) * static_cast<double>(half)));
      }
      for (int i = tid; i < n; i += nt) {
        const bool a = s_act[i];
        int sc1 = a ? (s_key[i] > thr ? s_cnt[i] + 1 : 0) : s_cnt[i];
        if (evict_now && i == worst) {
          sc1 = 0;
          s_bias[i] = new_bias;
          s_evict[i] = t_done + rep;
        }
        if (completed) s_cnt[i] = sc1;
      }
    }

    // -- checkpoint cadence and the next state ----------------------------
    const bool due = (step1 - last) >= every;
    const T t_after = due ? t_done + ckw : t_done;
    const bool ckpt_hit = completed && due && tint < t_done + ckw;
    const bool restart_at = interrupted || ckpt_hit;
    const bool rollback = cascade || interrupted;
    const T t_next = cascade      ? fwin + rst
                     : stalled    ? t + static_cast<T>(kStallRetryS)
                     : restart_at ? tint + rst
                                  : t_after;
    const int step_next = completed ? step1 : stalled ? step : last;
    const int last_next = (completed && due) ? step1 : last;
    const T watch_next = cascade      ? fwin
                         : stalled    ? t
                         : restart_at ? tint
                                      : -inf;
    for (int i = tid; i < n; i += nt) {
      s_wasup[i] = s_ups[i];
      if (!cascade) s_wasact[i] = s_act[i];
    }
    restarts += (rollback || ckpt_hit) ? 1 : 0;
    evictions += evict_now ? 1 : 0;
    lost = lost + (rollback ? static_cast<T>(step - last) : T(0));
    stall = stall + (stalled ? static_cast<T>(kStallRetryS)
                             : ((rollback || ckpt_hit) ? rst : T(0)));
    ckpt = ckpt + ((completed && due) ? ckw : T(0));
    t = t_next;
    step = step_next;
    last = last_next;
    watch = watch_next;
    ++it;
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt) {
    bias_io[ln + i] = s_bias[i];
    evict_io[ln + i] = s_evict[i];
    slow_io[ln + i] = s_cnt[i];
    wasup_io[ln + i] = s_wasup[i];
    wasact_io[ln + i] = s_wasact[i];
  }
  if (tid == 0) {
    t_io[lane] = t;
    step_io[lane] = step;
    last_io[lane] = last;
    watch_io[lane] = watch;
    failures_io[lane] = failures;
    restarts_io[lane] = restarts;
    evictions_io[lane] = evictions;
    lost_io[lane] = lost;
    stall_io[lane] = stall;
    ckpt_io[lane] = ckpt;
    it_out[lane] = it;
  }
}

template <typename T>
int launch(void* const* ptr, int lanes, int n_nodes, int n, int K, int KD,
           int window, int W, int track, int degrade, int sigma_zero,
           int max_iters, void* stream) {
  // ptr: the 13 params (base_step_s, mtbf_s, repair_s, ckpt_every,
  // ckpt_write_s, restart_s, sigma, evict_factor, degrade_s,
  // degrade_factor, min_nodes, total_steps, max_wall_s), the 6 tables
  // (fail_start, seed, degrade_t, fault node/start/end), the 15 carry
  // fields in _Carry order, and it.
  const size_t smem = static_cast<size_t>(n) * (5 * sizeof(T) + 9);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&fleet_loop_kernel<T>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto f = [&](int k) { return static_cast<T*>(ptr[k]); };
  auto i32 = [&](int k) { return static_cast<int*>(ptr[k]); };
  auto u8 = [&](int k) { return static_cast<uint8_t*>(ptr[k]); };
  fleet_loop_kernel<T><<<lanes, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      f(0), f(2), i32(3), f(4), f(5), f(6), f(7), f(9), f(10), i32(11),
      f(12), f(13), static_cast<const long long*>(ptr[14]), f(15), i32(16),
      f(17), f(18), f(19), i32(20), i32(21), f(22), i32(23), f(24), u8(25),
      u8(26), f(27), i32(28), i32(29), i32(30), f(31), f(32), f(33),
      i32(34), n_nodes, n, K, KD, window, W, track, degrade, sigma_zero,
      max_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_FLEET_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                      \
      void* p0, void* p1, void* p2, void* p3, void* p4, void* p5, void* p6, \
      void* p7, void* p8, void* p9, void* p10, void* p11, void* p12,        \
      void* p13, void* p14, void* p15, void* p16, void* p17, void* p18,     \
      void* p19, void* p20, void* p21, void* p22, void* p23, void* p24,     \
      void* p25, void* p26, void* p27, void* p28, void* p29, void* p30,     \
      void* p31, void* p32, void* p33, void* p34, int lanes, int n_nodes,   \
      int n, int K, int KD, int window, int W, int track, int degrade,      \
      int sigma_zero, int max_iters, void* stream) {                        \
    void* const ptr[35] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,  p8,     \
                           p9,  p10, p11, p12, p13, p14, p15, p16, p17,    \
                           p18, p19, p20, p21, p22, p23, p24, p25, p26,    \
                           p27, p28, p29, p30, p31, p32, p33, p34};        \
    return launch<T>(ptr, lanes, n_nodes, n, K, KD, window, W, track,       \
                     degrade, sigma_zero, max_iters, stream);               \
  }

REPRO_FLEET_ENTRY(fleet_loop_f64, double)
REPRO_FLEET_ENTRY(fleet_loop_f32, float)
