// Priced row-wise (min, argmin, second-min, raw) over the sparse
// engine's gathered [P, K] candidate block.
//
// Replaces the Pallas TPU kernel blance_tpu/ops/sparse2.py:130
// sparse_priced_min2 (kernel body _kernel, sparse2.py:82).  Per row r of
// x = score[r, :] + price[r, :] (both [P, K], the price gathered per
// candidate by the caller):
//   best   = min(x)
//   kidx   = the FIRST column that reaches the min (0 for an all-+inf row)
//   second = min(x with the kidx POSITION masked), so duplicate minima
//            give second == best
//   raw    = score[r, kidx], the unpriced score at the pick
//
// What bounds it on an H100: bytes.  It reads score and price once
// (P*K*8 bytes, 128 MB at [1M, 16]) and writes 16 bytes a row; at
// 3.35 TB/s that is 0.043 ms, while the three operations per element
// are far below the card's float32 rate.
//
// Design: one warp per row, 8 rows per 256-thread block.  K is small
// (tens) and not a power of two, so the warp's lanes stride over the
// row's columns in increasing order (neighbouring lanes on neighbouring
// addresses: one coalesced 4-byte-a-lane load per operand per 32
// columns), keep a running Min2 each, and merge by the shared rule of
// min2_block.cuh with warp shuffles only: no shared memory, no
// __syncthreads, nothing crosses warps.  The loop stops at K, so there
// is no ragged tail to mask; the sparse engine's pad columns (-1 ids)
// already score +inf.  Lane 0 then re-reads score[r, kidx] for raw.
// Rows with K < 32 leave lanes idle; packing several rows per warp is
// later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

#include "min2_block.cuh"

constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
sparse_min2_kernel(const float* __restrict__ score,
                   const float* __restrict__ price,
                   float* __restrict__ best, int* __restrict__ idx,
                   float* __restrict__ second, float* __restrict__ raw,
                   long long p, int k) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= p) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const float* srow = score + row * (long long)k;
  const float* prow = price + row * (long long)k;
  const float inf = __int_as_float(0x7f800000);
  Min2 m{inf, kEmpty, inf};
  for (int j = lane; j < k; j += 32) {
    push(m, srow[j] + prow[j], j);
  }
  m = warp_reduce(m);
  if (lane == 0) {
    best[row] = m.best;
    idx[row] = m.idx;
    second[row] = m.second;
    raw[row] = srow[m.idx];
  }
}

}  // namespace

// score, price [p, k] row-major contiguous; outputs [p] each.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blance_sparse_min2(const float* score, const float* price,
                                  float* best, int* idx, float* second,
                                  float* raw, long long p, long long k,
                                  void* stream) {
  if (p <= 0) return 0;
  if (k <= 0 || k > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = (p + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  sparse_min2_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(score, price, best, idx,
                                               second, raw, p, (int)k);
  return (int)cudaGetLastError();
}
