// Priced row-wise (min, argmin, second-min, raw) over the sparse
// engine's [P, K] candidate block, with the per-candidate price gathered
// in the kernel.
//
// Replaces the Pallas TPU kernel blance_tpu/ops/sparse2.py:130
// sparse_priced_min2 (kernel body _kernel, sparse2.py:82).  Per row r of
// x = score[r, :] + price[r, :]:
//   best   = min(x)
//   kidx   = the FIRST column that reaches the min (0 for an all-+inf row)
//   second = min(x with the kidx POSITION masked), so duplicate minima
//            give second == best
//   raw    = score[r, kidx], the unpriced score at the pick
// Two instantiations of one body:
//   - plain (blance_sparse_min2): price is a [P, K] matrix, as the TPU
//     kernel takes it;
//   - gathered (blance_sparse_min2_cand), what the sparse engine runs:
//     price[r, k] = price_n[clamp(cand[r, k], 0, N - 1)] from the [N]
//     price row and the int32 [P, K] candidate ids, and a fifth output
//     choice = max(cand[r, kidx], 0), the picked node id, so the caller
//     builds no [P, K] price matrix and looks up no id.
//
// What bounds it on an H100: bytes.  It reads score and cand (or price)
// once, P*K*8 bytes (128 MB at [1M, 16]), plus the 40 KB price row, and
// writes 16 or 20 bytes a row: 0.044 ms at 3.35 TB/s.  Three float
// operations an element are far below the card's float32 rate.
//
// Design: four lanes (a quad) per row, 64 rows per 256-thread block.
// When K % 4 == 0 and both [P, K] operands are 16-byte aligned, a lane
// loads its row's columns 16 bytes at a time (float4 score, int4 ids or
// float4 price): lane q takes columns 4q..4q+3, then every 16th column
// after them, so its columns still rise and a strict < keeps the first
// occurrence.  A warp's eight rows are contiguous, so one load
// instruction moves 512 contiguous bytes per operand.  Otherwise (K = 37,
// K = 1, an unaligned view) lane q takes columns q, q+4, ... with 4-byte
// loads.  The price row is read through the read-only path (__ldg) and
// stays in L1/L2.  Each lane carries the unpriced score and the candidate
// id beside its running min, so raw and choice need no dependent
// re-read; the quad merges by the shared rule of min2_block.cuh in two
// shuffle steps, and its lane 0 stores the row's outputs, a warp's eight
// rows landing on consecutive addresses.  No shared memory, no
// __syncthreads.  (Measured on the H100 at [1M, 16]: a quad per row beat
// two or four rows per quad, and two lanes or one lane per row.)

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

#include "min2_block.cuh"

constexpr int kLanesPerRow = 4;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;

// A running Min2 plus, at its best, the unpriced score and the id.
struct Pick {
  float best;
  int idx;
  float second;
  float raw;
  int cid;
};

__device__ __forceinline__ void push(Pick& m, float s, float pr, int j,
                                     int c) {
  const float x = s + pr;
  if (x < m.best || m.idx == kEmpty) {
    m.second = m.best;
    m.best = x;
    m.idx = j;
    m.raw = s;
    m.cid = c;
  } else if (x < m.second) {
    m.second = x;
  }
}

__device__ __forceinline__ Pick merge(const Pick& a, const Pick& b) {
  const bool take_b = (b.best < a.best) || (b.best == a.best && b.idx < a.idx);
  Pick r = take_b ? b : a;
  r.second = fminf(fmaxf(a.best, b.best), fminf(a.second, b.second));
  return r;
}

// Price of candidate id c: the [N] row at clamp(c, 0, n - 1).
__device__ __forceinline__ float price_at(const float* price_n, int c,
                                          int n) {
  return __ldg(price_n + min(max(c, 0), n - 1));
}

template <bool kGather, bool kVec>
__global__ void __launch_bounds__(kThreads)
sparse_min2_kernel(const float* __restrict__ score,
                   const float* __restrict__ price,  // [P, K] or [N]
                   const int* __restrict__ cand,     // [P, K] (gathered)
                   int n, float* __restrict__ best, int* __restrict__ idx,
                   float* __restrict__ second, float* __restrict__ raw,
                   int* __restrict__ choice, long long p, int k) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int q = threadIdx.x % kLanesPerRow;
  // Rows past the end do no loads but still join the quad's shuffles.
  const int kk = row < p ? k : 0;
  const long long base = row * (long long)k;
  const float inf = __int_as_float(0x7f800000);
  Pick m{inf, kEmpty, inf, inf, 0};
  if (kVec) {
    for (int c = q; c < kk / 4; c += kLanesPerRow) {
      const float4 s = reinterpret_cast<const float4*>(score + base)[c];
      float4 pr;
      int4 id = make_int4(0, 0, 0, 0);
      if (kGather) {
        id = reinterpret_cast<const int4*>(cand + base)[c];
        pr = make_float4(price_at(price, id.x, n), price_at(price, id.y, n),
                         price_at(price, id.z, n), price_at(price, id.w, n));
      } else {
        pr = reinterpret_cast<const float4*>(price + base)[c];
      }
      const int j = 4 * c;
      push(m, s.x, pr.x, j, id.x);
      push(m, s.y, pr.y, j + 1, id.y);
      push(m, s.z, pr.z, j + 2, id.z);
      push(m, s.w, pr.w, j + 3, id.w);
    }
  } else {
    for (int j = q; j < kk; j += kLanesPerRow) {
      int id = 0;
      float pr;
      if (kGather) {
        id = cand[base + j];
        pr = price_at(price, id, n);
      } else {
        pr = price[base + j];
      }
      push(m, score[base + j], pr, j, id);
    }
  }
  const unsigned full = 0xffffffffu;
  for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
    Pick o;
    o.best = __shfl_down_sync(full, m.best, off, kLanesPerRow);
    o.idx = __shfl_down_sync(full, m.idx, off, kLanesPerRow);
    o.second = __shfl_down_sync(full, m.second, off, kLanesPerRow);
    o.raw = __shfl_down_sync(full, m.raw, off, kLanesPerRow);
    o.cid = __shfl_down_sync(full, m.cid, off, kLanesPerRow);
    m = merge(m, o);
  }
  if (q == 0 && row < p) {
    best[row] = m.best;
    idx[row] = m.idx;
    second[row] = m.second;
    raw[row] = m.raw;
    if (kGather) choice[row] = max(m.cid, 0);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// vec picks the 16-byte-load instantiation (the caller decides, from K
// and the operands' alignment; refused when they do not allow it).
template <bool kGather>
int launch(const float* score, const float* price, const int* cand, int n,
           float* best, int* idx, float* second, float* raw, int* choice,
           long long p, long long k, int vec, void* stream) {
  if (p <= 0) return 0;
  if (k <= 0 || k > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long blocks = (p + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const void* other = kGather ? static_cast<const void*>(cand)
                              : static_cast<const void*>(price);
  if (vec && (k % 4 != 0 || !aligned16(score) || !aligned16(other)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    sparse_min2_kernel<kGather, true><<<(unsigned)blocks, kThreads, 0, s>>>(
        score, price, cand, n, best, idx, second, raw, choice, p, (int)k);
  } else {
    sparse_min2_kernel<kGather, false><<<(unsigned)blocks, kThreads, 0, s>>>(
        score, price, cand, n, best, idx, second, raw, choice, p, (int)k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// score, price [p, k] row-major contiguous; outputs [p] each.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blance_sparse_min2(const float* score, const float* price,
                                  float* best, int* idx, float* second,
                                  float* raw, long long p, long long k,
                                  int vec, void* stream) {
  return launch<false>(score, price, nullptr, 0, best, idx, second, raw,
                       nullptr, p, k, vec, stream);
}

// score [p, k] f32 and cand [p, k] int32 row-major contiguous, price_n
// [n] f32 (n >= 1); outputs [p] each, choice int32.
extern "C" int blance_sparse_min2_cand(const float* score, const int* cand,
                                       const float* price_n, long long n,
                                       float* best, int* idx, float* second,
                                       float* raw, int* choice, long long p,
                                       long long k, int vec, void* stream) {
  if (n <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  return launch<true>(score, price_n, cand, (int)n, best, idx, second, raw,
                      choice, p, k, vec, stream);
}
