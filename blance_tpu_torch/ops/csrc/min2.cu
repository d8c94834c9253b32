// Priced row-wise (min, argmin, second-min) for the matrix score engine.
//
// Replaces the Pallas TPU kernel blance_tpu/ops/reduce2.py:115
// priced_min2_argmin (kernel body _kernel, reduce2.py:68).  Per row r of
// x = score[r, :] + price[:]:
//   best   = min(x)
//   idx    = the FIRST column that reaches the min
//   second = min(x with the argmin POSITION masked), so duplicate minima
//            give second == best
// An all-+inf row gives idx 0, like jnp.argmin.
//
// What bounds it on an H100: one read of score (P*N*4 bytes, 4.0 GB at
// 100k x 10k, 1.19 ms at 3.35 TB/s); the price row and the [P] outputs are
// noise beside it.  About three operations per element, far below the
// card's float32 rate, so the kernel is bound by bytes.
//
// Design: one 256-thread block per row.  Threads stride over the row's
// columns with neighbouring threads on neighbouring addresses (coalesced
// loads), add the price as they load, and keep a running (best, idx,
// second).  Because a thread visits its columns in increasing order, a
// strict < keeps its first occurrence.  Partials merge by the Pallas
// kernel's own rule, second = min(max(b1, b2), min(s1, s2)), with the
// lower index winning on equal best: first by warp shuffles, then across
// the block's warps through shared memory.  Nothing crosses blocks, so
// no second pass and no atomics.  No TMA or wgmma yet: the loads are
// plain, and making them wider is later work.
//
// A batch of problems (the fleet tier) is one launch over the stacked
// [B*P, N] score, each row priced by its own problem's [N] price row.  At
// fleet widths (N = 8-64) most of a row's 256 threads see no column; a
// design with several rows per block is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

#include "min2_block.cuh"

// kBatched: the score is a batch of [rows_per_price, n] problems stacked
// as [rows, n], and row r adds the price row of its problem,
// price[(r / rows_per_price) * n : ...] (the fleet tier's launch).
template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
priced_min2_kernel(const float* __restrict__ score,
                   const float* __restrict__ price,
                   float* __restrict__ best, int* __restrict__ idx,
                   float* __restrict__ second, int n,
                   long long rows_per_price) {
  const long long row = blockIdx.x;
  const float* rowp = score + row * (long long)n;
  if constexpr (kBatched) price += (row / rows_per_price) * (long long)n;
  const float inf = __int_as_float(0x7f800000);
  Min2 m{inf, kEmpty, inf};
  for (int j = threadIdx.x; j < n; j += kThreads) {
    push(m, rowp[j] + price[j], j);
  }
  m = block_reduce(m);
  if (threadIdx.x == 0) {
    best[row] = m.best;
    idx[row] = m.idx;
    second[row] = m.second;
  }
}

}  // namespace

// score [p, n] row-major contiguous, price [n]; outputs [p] each.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blance_priced_min2(const float* score, const float* price,
                                  float* best, int* idx, float* second,
                                  long long p, long long n, void* stream) {
  if (p <= 0) return 0;
  if (n <= 0 || n > INT_MAX || p > INT_MAX) return (int)cudaErrorInvalidValue;
  priced_min2_kernel<false><<<(unsigned)p, kThreads, 0,
                              (cudaStream_t)stream>>>(
      score, price, best, idx, second, (int)n, p);
  return (int)cudaGetLastError();
}

// A batch of problems: score [rows, n] stacks rows / rows_per_price
// problems of rows_per_price rows each, price [rows / rows_per_price, n]
// holds one price row per problem; outputs [rows] each.
extern "C" int blance_priced_min2_batched(const float* score,
                                          const float* price, float* best,
                                          int* idx, float* second,
                                          long long rows, long long n,
                                          long long rows_per_price,
                                          void* stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || n > INT_MAX || rows > INT_MAX || rows_per_price <= 0 ||
      rows % rows_per_price != 0)
    return (int)cudaErrorInvalidValue;
  priced_min2_kernel<true><<<(unsigned)rows, kThreads, 0,
                             (cudaStream_t)stream>>>(
      score, price, best, idx, second, (int)n, rows_per_price);
  return (int)cudaGetLastError();
}
