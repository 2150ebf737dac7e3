// Shared (value, index) and integer reductions for the port's kernels.
//
// Tie rule everywhere: the smaller value wins, and between equal values
// the smaller index wins — the first occurrence, as jnp.argmin and
// torch.argmin break ties.  Each thread first scans its own elements in
// increasing index order with a strict `<`, so its pair already holds its
// first occurrence; the combine below then keeps the lowest index across
// threads and warps.  A pair that saw no finite-or-smaller value keeps
// index INT_MAX; callers map that to 0, which is what argmin returns for
// an all-+inf row.
#pragma once

#include <climits>
#include <cuda_runtime.h>

#define REPRO_FULL_MASK 0xffffffffu

extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

template <typename T>
__device__ __forceinline__ void vi_take(T& v, int& i, T ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Warp-wide (min, first index); every lane ends with the result.
template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T ov = __shfl_xor_sync(REPRO_FULL_MASK, v, off);
    int oi = __shfl_xor_sync(REPRO_FULL_MASK, i, off);
    vi_take(v, i, ov, oi);
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(REPRO_FULL_MASK, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T o = __shfl_xor_sync(REPRO_FULL_MASK, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T o = __shfl_xor_sync(REPRO_FULL_MASK, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Block-wide reductions.  Every thread of the block must call them (they
// synchronise), and every thread receives the result.  `scratch` is shared
// memory of at least 32 entries of the given type; blockDim.x is a
// multiple of 32 and at most 1024.

template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : T(0);
  return warp_sum(v);
}

template <typename T>
__device__ T block_max(T v, T lowest, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : lowest;
  return warp_max(v);
}

template <typename T>
__device__ T block_min(T v, T highest, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_min(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : highest;
  return warp_min(v);
}

template <typename T>
__device__ void block_argmin(T& v, int& i, T* vscratch, int* iscratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmin(v, i);
  __syncthreads();
  if (lane == 0) {
    vscratch[warp] = v;
    iscratch[warp] = i;
  }
  __syncthreads();
  if (lane < nwarps) {
    v = vscratch[lane];
    i = iscratch[lane];
  } else {
    v = vscratch[0];
    i = iscratch[0];
  }
  warp_argmin(v, i);
}

// Inclusive prefix sum of one int per thread, in thread order; `total`
// receives the block's sum.  scratch: 32 ints.
__device__ int block_inclusive_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int o = __shfl_up_sync(REPRO_FULL_MASK, v, off);
    if (lane >= off) v += o;
  }
  __syncthreads();
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  int w = lane < nwarps ? scratch[lane] : 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int o = __shfl_up_sync(REPRO_FULL_MASK, w, off);
    if (lane >= off) w += o;
  }
  // w on lane k is the sum of warps 0..k
  int before = __shfl_sync(REPRO_FULL_MASK, w, warp > 0 ? warp - 1 : 0);
  total = __shfl_sync(REPRO_FULL_MASK, w, nwarps - 1);
  return warp > 0 ? v + before : v;
}
