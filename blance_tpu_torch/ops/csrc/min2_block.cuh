// Warp- and block-wide (min, argmin, second-min) shared by min2.cu,
// score_fused.cu and sparse_min2.cu: the merge rule of the Pallas kernels
// (blance_tpu/ops/reduce2.py:_kernel).  A thread pushes its columns in
// increasing order (strict < keeps the first occurrence); partials merge
// with second = min(max(b1, b2), min(s1, s2)) and the lower index winning
// on equal best, so duplicate minima give second == best and an all-+inf
// row gives index 0.  Included once per translation unit, inside its
// anonymous namespace, after <climits> and <cuda_runtime.h>.
#pragma once

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEmpty = INT_MAX;  // partial that has seen no column yet

struct Min2 {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ void push(Min2& m, float x, int j) {
  if (x < m.best || m.idx == kEmpty) {
    m.second = m.best;
    m.best = x;
    m.idx = j;
  } else if (x < m.second) {
    m.second = x;
  }
}

__device__ __forceinline__ Min2 merge(const Min2& a, const Min2& b) {
  const bool take_b = (b.best < a.best) || (b.best == a.best && b.idx < a.idx);
  Min2 r;
  r.best = take_b ? b.best : a.best;
  r.idx = take_b ? b.idx : a.idx;
  r.second = fminf(fmaxf(a.best, b.best), fminf(a.second, b.second));
  return r;
}

// Merge the partials of the first ``width`` lanes of a warp (a power of
// two, at most 32); every lane of the warp must call it.
__device__ __forceinline__ Min2 warp_reduce(Min2 m, int width = 32) {
  const unsigned full = 0xffffffffu;
  for (int off = width / 2; off > 0; off >>= 1) {
    Min2 o;
    o.best = __shfl_down_sync(full, m.best, off);
    o.idx = __shfl_down_sync(full, m.idx, off);
    o.second = __shfl_down_sync(full, m.second, off);
    m = merge(m, o);
  }
  return m;  // valid in lane 0
}

__device__ __forceinline__ Min2 block_reduce(Min2 m) {
  __shared__ Min2 warp_part[kWarps];
  m = warp_reduce(m);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_part[lane]
                      : Min2{__int_as_float(0x7f800000), kEmpty,
                             __int_as_float(0x7f800000)};
    m = warp_reduce(m, kWarps);
  }
  return m;  // valid in thread 0
}
