// Fused masked (min, first-occurrence argmin) over the last axis of [R, M].
//
// Replaces: repro/kernels/next_event.py::next_event (the Pallas kernel
// _next_event_kernel), the "which candidate happens next" reduction every
// vec engine runs; on the netdc path it is ops.argmin over [B, D] once per
// routing decision, and the power engine's picks use the same combine as a
// device function inside power_scan.cu.
//
// What bounds it on an H100: bytes.  It reads R*M values (+ R*M mask bytes)
// once and writes R values and R int32 indices, with one compare per
// element, far below the card's compute rate.  At the netdc shape
// ([1024, 16] f64) the whole input is 160 KB, so a launch is bound by
// launch latency (a few microseconds), not by either rate.
//
// Design: one warp per row, eight rows per 256-thread block, a grid-stride
// loop over rows.  Rows on the main path are short (M = D = 16), so one
// warp per row keeps the lanes busy without a block-wide reduction; long
// rows (M in the thousands) are walked by the same warp in coalesced
// 32-element strides.  Each lane scans its strided elements in increasing
// index order with a strict `<`, then the warp combines (value, index)
// pairs with the lower index winning ties — the first occurrence, as in
// jnp.argmin.  A masked-out slot reads as +inf; an all-+inf row returns
// (inf, 0).  f32 and f64 are both native on Hopper (the TPU ran f64 only
// in interpret mode).
#include <cmath>
#include <cstdint>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void next_event_kernel(const T* __restrict__ times,
                                  const uint8_t* __restrict__ mask,
                                  long long rows, long long m,
                                  T* __restrict__ vmin,
                                  int* __restrict__ imin) {
  const int lane = threadIdx.x & 31;
  const long long warp = threadIdx.x >> 5;
  const T inf = static_cast<T>(INFINITY);
  for (long long r = blockIdx.x * (long long)kRowsPerBlock + warp; r < rows;
       r += (long long)gridDim.x * kRowsPerBlock) {
    const T* row = times + r * m;
    const uint8_t* mrow = mask ? mask + r * m : nullptr;
    T v = inf;
    int i = INT_MAX;
    for (long long j = lane; j < m; j += 32) {
      T x = (mrow && !mrow[j]) ? inf : row[j];
      if (x < v) {
        v = x;
        i = static_cast<int>(j);
      }
    }
    warp_argmin(v, i);
    if (lane == 0) {
      vmin[r] = v;
      imin[r] = i == INT_MAX ? 0 : i;
    }
  }
}

template <typename T>
int launch(const void* times, const void* mask, long long rows, long long m,
           void* vmin, void* imin, void* stream) {
  long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  next_event_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(times), static_cast<const uint8_t*>(mask), rows,
      m, static_cast<T*>(vmin), static_cast<int*>(imin));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int next_event_f32(const void* times, const void* mask,
                              long long rows, long long m, void* vmin,
                              void* imin, void* stream) {
  return launch<float>(times, mask, rows, m, vmin, imin, stream);
}

extern "C" int next_event_f64(const void* times, const void* mask,
                              long long rows, long long m, void* vmin,
                              void* imin, void* stream) {
  return launch<double>(times, mask, rows, m, vmin, imin, stream);
}
