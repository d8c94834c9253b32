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
// Two layouts, chosen by the launcher's caller (ops/reduce2.py
// min2_layout: float4 loads first, then the lane count from that case's
// table, both tables measured on the H100 by chip_smoke.py's narrow
// sweep): rows per warp up to N = 2048 on rows of float4 loads and up to
// N = 777 on rows of 4-byte loads, a block per row above.
//
// - Block per row (wide rows, the main path's N = 10 000): one 256-thread
//   block per row.  Threads stride over the row's columns with
//   neighbouring threads on neighbouring addresses (coalesced loads), add
//   the price as they load, and keep a running (best, idx, second).
//   Partials merge first by warp shuffles, then across the block's warps
//   through shared memory.
// - Rows per warp (narrow rows, the fleet tier's N = 8-64 and anything
//   up to the threshold): a group of L lanes of a warp per row (L a power
//   of two, at most 32, about 8-64 columns a lane), 256 / L rows per
//   block.  Lane q takes
//   columns q, q + L, ... or, when n % 4 == 0 and both operands are
//   16-byte aligned, the float4 chunks q, q + L, ... (columns 4q..4q+3,
//   then 4(q+L)...).  The group merges by shuffles of width L only (the
//   group's leader reads nothing outside its group): no shared memory, no
//   __syncthreads, and a warp's 32 / L rows are contiguous, so its loads
//   cover one contiguous span.
//
// In both, a thread visits its columns in increasing order, so a strict <
// keeps its first occurrence, and partials merge by the Pallas kernel's
// own rule, second = min(max(b1, b2), min(s1, s2)), with the lower index
// winning on equal best.  That rule does not depend on the order of the
// merges, so every layout gives the same bits.  Nothing crosses blocks:
// no second pass and no atomics.  No TMA or wgmma: plain loads.
//
// A batch of problems (the fleet tier) is one launch over the stacked
// [B*P, N] score, each row priced by its own problem's [N] price row (a
// template flag, in either layout).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

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

// Rows per warp: 1 << log_lanes lanes a row, kThreads >> log_lanes rows
// a block; kVec: float4 loads (n % 4 == 0, both operands 16-byte
// aligned).  Lanes of a row past the end load nothing but still join the
// group's shuffles.
template <bool kBatched, bool kVec>
__global__ void __launch_bounds__(kThreads)
priced_min2_rows_kernel(const float* __restrict__ score,
                        const float* __restrict__ price,
                        float* __restrict__ best, int* __restrict__ idx,
                        float* __restrict__ second, long long rows, int n,
                        long long rows_per_price, int log_lanes) {
  const int lanes = 1 << log_lanes;
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> log_lanes;
  const int q = threadIdx.x & (lanes - 1);
  const float inf = __int_as_float(0x7f800000);
  Min2 m{inf, kEmpty, inf};
  if (row < rows) {
    const float* rowp = score + row * (long long)n;
    const float* pr = price;
    if constexpr (kBatched) pr += (row / rows_per_price) * (long long)n;
    if constexpr (kVec) {
      const float4* s4 = reinterpret_cast<const float4*>(rowp);
      const float4* p4 = reinterpret_cast<const float4*>(pr);
      for (int c = q; c < n / 4; c += lanes) {
        const float4 s = s4[c];
        const float4 p = __ldg(p4 + c);
        const int j = 4 * c;
        push(m, s.x + p.x, j);
        push(m, s.y + p.y, j + 1);
        push(m, s.z + p.z, j + 2);
        push(m, s.w + p.w, j + 3);
      }
    } else {
      for (int j = q; j < n; j += lanes) push(m, rowp[j] + __ldg(pr + j), j);
    }
  }
  m = warp_reduce(m, lanes);
  if (q == 0 && row < rows) {
    best[row] = m.best;
    idx[row] = m.idx;
    second[row] = m.second;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// lanes == 0: block per row (vec must be 0); lanes a power of two up to
// 32: rows per warp.  Anything else, or vec where the row or the
// operands do not allow float4 loads, is refused.
template <bool kBatched>
int launch(const float* score, const float* price, float* best, int* idx,
           float* second, long long rows, long long n,
           long long rows_per_price, int lanes, int vec,
           cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (n <= 0 || n > INT_MAX || rows > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (vec && (lanes == 0 || n % 4 != 0 || !aligned16(score) ||
              !aligned16(price)))
    return (int)cudaErrorInvalidValue;
  if (lanes == 0) {
    priced_min2_kernel<kBatched><<<(unsigned)rows, kThreads, 0, stream>>>(
        score, price, best, idx, second, (int)n, rows_per_price);
    return (int)cudaGetLastError();
  }
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes && log_lanes < 5) ++log_lanes;
  if ((1 << log_lanes) != lanes) return (int)cudaErrorInvalidValue;
  const long long rows_per_block = kThreads >> log_lanes;
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  if (vec)
    priced_min2_rows_kernel<kBatched, true><<<blocks, kThreads, 0, stream>>>(
        score, price, best, idx, second, rows, (int)n, rows_per_price,
        log_lanes);
  else
    priced_min2_rows_kernel<kBatched, false><<<blocks, kThreads, 0, stream>>>(
        score, price, best, idx, second, rows, (int)n, rows_per_price,
        log_lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// score [p, n] row-major contiguous, price [n]; outputs [p] each; lanes
// and vec pick the layout as launch() says.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int blance_priced_min2(const float* score, const float* price,
                                  float* best, int* idx, float* second,
                                  long long p, long long n, int lanes,
                                  int vec, void* stream) {
  return launch<false>(score, price, best, idx, second, p, n, p, lanes, vec,
                       (cudaStream_t)stream);
}

// A batch of problems: score [rows, n] stacks rows / rows_per_price
// problems of rows_per_price rows each, price [rows / rows_per_price, n]
// holds one price row per problem; outputs [rows] each.
extern "C" int blance_priced_min2_batched(const float* score,
                                          const float* price, float* best,
                                          int* idx, float* second,
                                          long long rows, long long n,
                                          long long rows_per_price,
                                          int lanes, int vec, void* stream) {
  if (rows > 0 && (rows_per_price <= 0 || rows % rows_per_price != 0))
    return (int)cudaErrorInvalidValue;
  return launch<true>(score, price, best, idx, second, rows, n,
                      rows_per_price, lanes, vec, (cudaStream_t)stream);
}
