// Auction score evaluated in-kernel, fused with the priced min2.
//
// Replaces the Pallas TPU kernel blance_tpu/ops/score_fused.py:254
// fused_score_min2 (kernel body _kernel, score_fused.py:160).  For every
// (row r, column j) the kernel evaluates the auction score in the
// reference kernel's own term order (score_fused.py:182-214):
//
//   s  = base[j] + (neg_boost[j] > 0 ? max(neg_boost[j], stick[r]) : 0)
//   s -= 0.01 * (prev_slot[r] == g)                   same-ordinal bonus
//   s -= stick[r] * (g in prev_state[r, :])           sticky holder
//   s += any_anchor[r] > 0 ? pen : 0                  hierarchy tier
//        pen = min over rules i that every present anchor satisfies of
//              i * 1e4, else 1e6
//   s += 1e9 * (g in taken[r, :] || validf[j] == 0)   forbidden
//   s  = fma(jitter_scale, jitter_hash(pbase + r, g), s)   tie-break
//
// with g = noff + j the global column id, and reduces x = s + price[j]
// per row to (best, local idx, second, raw = best - price[idx]) under the
// same rules as min2.cu: first index on ties, second-min by position.
//
// Rounding: the library is built with -fmad=false, so no expression is
// contracted behind the plain PyTorch version's back.  The one fused
// multiply-add is the jitter, spelled fmaf here because XLA contracts
// that add in the reference (the plain version rounds it once too).  The
// other products (0.01 * 0/1, stick * 0/1, 1e9 * 0/1) are exact.  The
// hash runs in uint32_t, where wraparound is defined, and keeps the low
// 16 bits, which equal the reference's int32 two's-complement result.
//
// What bounds it on an H100: it reads O(P + N) bytes and never the
// [P, N] matrix, so it is bound by the integer and float32 operations
// per cell (21 + 2R + 2T + nrules (5A + 2) by chip_smoke.py's count,
// which gives its bound), and in practice by the rate at which the SMs
// issue them: every compare and select takes an issue slot.
//
// Two layouts, chosen by the launcher's caller from N (ops/score_fused.py
// fused_lanes, a table measured on the H100 by chip_smoke.py's narrow
// sweep): narrow rows up to N = 1024, the wide tile above (the main
// path's N = 10 000).
// Both evaluate the same cell() and merge by the rule of min2.cu, so
// they give the same bits.
//
// Wide tile: a block owns a tile of kRowsPerTile rows and walks the
// columns in chunks of kColsPerThread columns a thread (thread t takes
// columns t, t + 256, ... so each thread's columns rise and a strict <
// keeps the first occurrence).  A thread loads its columns' terms once
// per chunk (base, neg_boost, validf, price, the rules' candidate group
// ids, g and the hash's column term) and evaluates them for every row of
// the tile, keeping one running Min2 per row in registers: each
// [N]-vector load serves kRowsPerTile cells.  At the end of a tile each
// row is merged across its warp by shuffles, then across the block's
// eight warps by one warp.  (Measured on the H100 at the main path's
// widths: 16 rows x 2 columns a chunk beat 8 x 2, 8 x 4, 16 x 1, 16 x 4
// and 32 x 2.)  At narrow rows most of a chunk's columns are empty and
// the tile-end merge dominates, hence:
//
// Narrow rows: a group of L lanes of a warp per row (L a power of two,
// at most 32, about 64 columns a lane), 256 / L rows a block.  Lane q
// evaluates its row's columns q, q + L, ... with the column terms loaded
// once each through the read-only path (a problem's [N] vectors are a
// few KB and stay in L1), and the row's lanes merge by shuffles of width
// L only: no tile-end pass through shared memory.
//
// In both, the rows' terms (stick, prev_slot, the hash's row term, the
// rule gate, the prev_state, taken and anchor ids) are staged once per
// block in shared memory; the present anchors are compacted first and
// the absent slots repeat a present one, so an absent anchor costs
// nothing per cell (the AND is idempotent), and the gate is cleared where
// no anchor is present (every rule is then met and the term is + 0
// either way).  The widths (nrules, R, T, A) are template parameters, so
// the loops unroll and a row's terms come from shared memory in 16-byte
// loads; the main path's widths and the test fixtures' have their own
// instantiation, and one with runtime widths takes any other shape.
// Every cell costs issue slots, so the cell has no branch (the wide
// tile tests j < n only in its last chunk): the running Min2 is updated
// by selects (push_finite), the forbidden term is one
// select against a per-column 0 / 1e9, and the hash's h / 65536 is built
// from its bits (128 + h * 2^-16, minus 128: exact) instead of an
// integer-to-float conversion, which issues at a quarter of the rate.
// Index arithmetic is 32-bit (the launcher refuses shapes that overflow
// it).  No tensor cores: the work is compares and adds.
//
// A batch of same-shaped problems (the fleet tier) is one launch of a
// batched kernel in either layout, the problem on blockIdx.y
// (for_problem); the one-problem launches are separate kernels over the
// same code.
//
// The score of a cell and what feeds it are score_cell.cuh's, shared
// with score_write.cu (the matrix engine's [P, N] score).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

#include "min2_block.cuh"
#include "score_cell.cuh"

constexpr int kRowsPerTile = 16;
constexpr int kColsPerThread = 2;

// The fused kernel's priced score of one cell.
template <int kNR>
__device__ __forceinline__ float cell(const Args& a, const int* w,
                                      const Col<kNR>& c, int j, int nr,
                                      int rw, int tw, int aw) {
  return score<false>(a, w, c, j, nr, rw, tw, aw) + c.price;
}

// push without the first-column test, as two compares and four selects
// (PTX, so that the compiler keeps them selects: a branch per cell would
// cut the unrolled tile into blocks it cannot interleave).  A partial
// that has seen only +inf keeps idx == kEmpty, which the row's final
// merge maps to 0 (the first column, as for an all-+inf row).  Scores
// are never NaN.
__device__ __forceinline__ void push_finite(Min2& m, float x, int j) {
  asm("{\n\t.reg .pred lt, lt2;\n\t"
      "setp.lt.f32 lt, %3, %0;\n\t"
      "setp.lt.f32 lt2, %3, %2;\n\t"
      "selp.f32 %2, %3, %2, lt2;\n\t"
      "selp.f32 %2, %0, %2, lt;\n\t"
      "selp.b32 %1, %4, %1, lt;\n\t"
      "selp.f32 %0, %3, %0, lt;\n\t}"
      : "+f"(m.best), "+r"(m.idx), "+f"(m.second)
      : "f"(x), "r"(j));
}

// One block's tile of rows of one problem.
template <int kNR, int kR, int kT, int kA>
__device__ __forceinline__ void fused_tile(const Args& a) {
  constexpr bool kFixed = kNR != kDyn;
  constexpr int kW = kFixed ? row_words(kNR, kR, kT, kA) : 4;
  const int nr = kFixed ? kNR : a.nrules;
  const int rw = kFixed ? kR : a.r_width;
  const int tw = kFixed ? kT : a.t_width;
  const int aw = kFixed ? kA : a.a_width;
  const int nwords = kFixed ? kW : row_words(nr, rw, tw, aw);
  extern __shared__ int4 smem4[];
  int* srow = reinterpret_cast<int*>(smem4);  // [kRowsPerTile][nwords]
  Min2* spart = reinterpret_cast<Min2*>(srow + kRowsPerTile * nwords);
  const int row0 = blockIdx.x * kRowsPerTile;
  if (threadIdx.x < kRowsPerTile)
    stage_row(a, srow + threadIdx.x * nwords, row0 + threadIdx.x, nr, rw,
              tw, aw, nwords);
  __syncthreads();

  const float inf = __int_as_float(0x7f800000);
  Min2 m[kRowsPerTile];
#pragma unroll
  for (int rr = 0; rr < kRowsPerTile; ++rr) m[rr] = Min2{inf, kEmpty, inf};

  // One chunk: each thread's kColsPerThread columns against every row of
  // the tile.  Only the last chunk (kTail) tests j < n.
  auto chunk = [&](int j0, auto tail) {
    constexpr bool kTail = decltype(tail)::value;
    Col<kFixed ? kNR : 0> col[kColsPerThread];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int j = j0 + c * kThreads;
      col[c] = load_col<kFixed ? kNR : 0>(a, !kTail || j < a.n ? j : 0);
    }
#pragma unroll
    for (int rr = 0; rr < kRowsPerTile; ++rr) {
      const int* w = srow + rr * nwords;
      int v[kW];  // a fixed-width row's words, in registers
      if constexpr (kFixed) {
#pragma unroll
        for (int q = 0; q < kW / 4; ++q) {
          const int4 x = reinterpret_cast<const int4*>(w)[q];
          v[4 * q] = x.x;
          v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z;
          v[4 * q + 3] = x.w;
        }
      }
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int j = j0 + c * kThreads;
        if (!kTail || j < a.n)
          push_finite(m[rr], cell(a, kFixed ? v : w, col[c], j, nr, rw, tw,
                                  aw), j);
      }
    }
  };
  constexpr int kStep = kThreads * kColsPerThread;
  const int n_full = a.n / kStep * kStep;
  for (int j0 = threadIdx.x; j0 < n_full; j0 += kStep)
    chunk(j0, std::false_type{});
  if (n_full < a.n) chunk(n_full + threadIdx.x, std::true_type{});

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int rr = 0; rr < kRowsPerTile; ++rr) {
    const Min2 r = warp_reduce(m[rr]);
    if (lane == 0) spart[rr * kWarps + warp] = r;
  }
  __syncthreads();
  for (int rr = warp; rr < kRowsPerTile; rr += kWarps) {
    Min2 r = lane < kWarps ? spart[rr * kWarps + lane]
                           : Min2{inf, kEmpty, inf};
    r = warp_reduce(r, kWarps);
    if (r.idx == kEmpty) r.idx = 0;  // an all-+inf row: the first column
    const int row = row0 + rr;
    if (lane == 0 && row < a.p) {
      a.best[row] = r.best;
      a.idx[row] = r.idx;
      a.second[row] = r.second;
      a.raw[row] = r.best - a.price[r.idx];
    }
  }
}

// Narrow rows: 1 << log_lanes lanes a row, kThreads >> log_lanes rows a
// block.  The block's rows are staged as in fused_tile; lane q of a row
// evaluates columns q, q + L, ... against that row (its column terms
// loaded once, through the read-only path, where a problem's few [N]
// vectors stay in L1), and the row's lanes merge by shuffles of width L.
template <int kNR, int kR, int kT, int kA>
__device__ __forceinline__ void fused_rows(const Args& a, int log_lanes) {
  constexpr bool kFixed = kNR != kDyn;
  constexpr int kW = kFixed ? row_words(kNR, kR, kT, kA) : 4;
  const int nr = kFixed ? kNR : a.nrules;
  const int rw = kFixed ? kR : a.r_width;
  const int tw = kFixed ? kT : a.t_width;
  const int aw = kFixed ? kA : a.a_width;
  const int nwords = kFixed ? kW : row_words(nr, rw, tw, aw);
  const int lanes = 1 << log_lanes;
  const int rows = kThreads >> log_lanes;
  extern __shared__ int4 smem4[];
  int* srow = reinterpret_cast<int*>(smem4);  // [rows][nwords]
  const int row0 = blockIdx.x * rows;
  if (threadIdx.x < rows)
    stage_row(a, srow + threadIdx.x * nwords, row0 + threadIdx.x, nr, rw,
              tw, aw, nwords);
  __syncthreads();

  const int rr = threadIdx.x >> log_lanes;
  const int q = threadIdx.x & (lanes - 1);
  const int row = row0 + rr;
  const int* w = srow + rr * nwords;
  int v[kW];  // a fixed-width row's words, in registers
  if constexpr (kFixed) {
#pragma unroll
    for (int k = 0; k < kW / 4; ++k) {
      const int4 x = reinterpret_cast<const int4*>(w)[k];
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }
  const float inf = __int_as_float(0x7f800000);
  Min2 m{inf, kEmpty, inf};
  const int n = row < a.p ? a.n : 0;  // a row past the end: no column
#pragma unroll 4
  for (int j = q; j < n; j += lanes)
    push_finite(m, cell(a, kFixed ? v : w, load_col<kFixed ? kNR : 0>(a, j),
                        j, nr, rw, tw, aw), j);
  m = warp_reduce(m, lanes);
  if (q == 0 && row < a.p) {
    if (m.idx == kEmpty) m.idx = 0;  // an all-+inf row: the first column
    a.best[row] = m.best;
    a.idx[row] = m.idx;
    a.second[row] = m.second;
    a.raw[row] = m.best - a.price[m.idx];
  }
}

template <int kNR, int kR, int kT, int kA>
__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(Args a, int log_lanes) {
  fused_rows<kNR, kR, kT, kA>(a, log_lanes);
}

template <int kNR, int kR, int kT, int kA>
__global__ void __launch_bounds__(kThreads)
fused_rows_batched_kernel(Args problems, int log_lanes) {
  fused_rows<kNR, kR, kT, kA>(for_problem(problems, blockIdx.y), log_lanes);
}

template <int kNR, int kR, int kT, int kA>
__global__ void __launch_bounds__(kThreads)
fused_score_min2_kernel(Args a) {
  fused_tile<kNR, kR, kT, kA>(a);
}

template <int kNR, int kR, int kT, int kA>
__global__ void __launch_bounds__(kThreads)
fused_score_min2_batched_kernel(Args problems) {
  fused_tile<kNR, kR, kT, kA>(for_problem(problems, blockIdx.y));
}

// batch < 0: one problem, the unbatched kernel; else a batch of
// ``batch``.  lanes == 0: the wide tile; lanes a power of two up to 32:
// narrow rows, that many lanes a row; anything else is refused.
template <int kNR, int kR, int kT, int kA>
int launch(const Args& a, int batch, int lanes, cudaStream_t stream) {
  if (kNR != kDyn && (a.nrules != kNR || a.r_width != kR ||
                      a.t_width != kT || (kNR > 0 && a.a_width != kA)))
    return (int)cudaErrorInvalidValue;  // widths of another instantiation
  int log_lanes = 0;
  while ((1 << log_lanes) < lanes && log_lanes < 5) ++log_lanes;
  if (lanes != 0 && (1 << log_lanes) != lanes)
    return (int)cudaErrorInvalidValue;
  const int nwords = row_words(a.nrules, a.r_width, a.t_width,
                               a.nrules > 0 ? a.a_width : 0);
  const int rows = lanes ? kThreads >> log_lanes : kRowsPerTile;
  const size_t smem = sizeof(int) * (size_t)rows * nwords +
                      (lanes ? 0 : sizeof(Min2) * (size_t)kRowsPerTile *
                                       kWarps);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((long long)a.p + rows - 1) / rows);
  const dim3 grid(blocks, batch < 0 ? 1 : batch);
  if (lanes == 0 && batch < 0)
    fused_score_min2_kernel<kNR, kR, kT, kA><<<grid, kThreads, smem,
                                               stream>>>(a);
  else if (lanes == 0)
    fused_score_min2_batched_kernel<kNR, kR, kT, kA><<<grid, kThreads, smem,
                                                       stream>>>(a);
  else if (batch < 0)
    fused_rows_kernel<kNR, kR, kT, kA><<<grid, kThreads, smem, stream>>>(
        a, log_lanes);
  else
    fused_rows_batched_kernel<kNR, kR, kT, kA><<<grid, kThreads, smem,
                                                 stream>>>(a, log_lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes as in Args; every array row-major contiguous.  variant picks the
// instantiation, as score_fused.py's FUSED_VARIANTS lists them by
// (nrules, R, T, A); -1 is the runtime-width one.  Returns
// cudaGetLastError() after the launch (0 = launched).
namespace {

int launch_variant(const float* price, const float* base,
                   const float* neg_boost, const float* validf,
                   const int* cand_g, const float* stick,
                   const int* prev_slot, const int* prev_state,
                   const int* taken, const float* present,
                   const int* a_inc_g, const int* a_exc_g,
                   const float* any_anchor, float* best, int* idx,
                   float* second, float* raw, float jitter_scale,
                   long long p, long long n, int nrules, int r_width,
                   int t_width, int a_width, int g_width, int pbase,
                   int noff, int variant, long long batch, int lanes,
                   void* stream) {
  if (p <= 0 || batch == 0) return 0;
  if (!shapes_fit(p, n, nrules, r_width, t_width, a_width, g_width, batch))
    return (int)cudaErrorInvalidValue;
  Args a{price, base, neg_boost, validf, cand_g, stick, prev_slot,
         prev_state, taken, present, a_inc_g, a_exc_g, any_anchor,
         best, idx, second, raw, jitter_scale, (int)p, (int)n, nrules,
         r_width, t_width, a_width, g_width, pbase, noff};
  const cudaStream_t s = (cudaStream_t)stream;
  const int b = (int)batch;
  switch (variant) {
    case 0: return launch<1, 1, 2, 2>(a, b, lanes, s);
    case 1: return launch<0, 1, 1, 0>(a, b, lanes, s);
    case 2: return launch<0, 2, 1, 0>(a, b, lanes, s);
    case 3: return launch<1, 2, 3, 3>(a, b, lanes, s);
    case -1: return launch<kDyn, kDyn, kDyn, kDyn>(a, b, lanes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int blance_fused_score_min2(
    const float* price, const float* base, const float* neg_boost,
    const float* validf, const int* cand_g, const float* stick,
    const int* prev_slot, const int* prev_state, const int* taken,
    const float* present, const int* a_inc_g, const int* a_exc_g,
    const float* any_anchor, float* best, int* idx, float* second,
    float* raw, float jitter_scale, long long p, long long n, int nrules,
    int r_width, int t_width, int a_width, int g_width, int pbase, int noff,
    int variant, int lanes, void* stream) {
  return launch_variant(price, base, neg_boost, validf, cand_g, stick,
                        prev_slot, prev_state, taken, present, a_inc_g,
                        a_exc_g, any_anchor, best, idx, second, raw,
                        jitter_scale, p, n, nrules, r_width, t_width,
                        a_width, g_width, pbase, noff, variant, -1, lanes,
                        stream);
}

// A batch of ``batch`` problems of p rows and n columns each, every array
// with a leading [batch] axis; the problem rides blockIdx.y.
extern "C" int blance_fused_score_min2_batched(
    const float* price, const float* base, const float* neg_boost,
    const float* validf, const int* cand_g, const float* stick,
    const int* prev_slot, const int* prev_state, const int* taken,
    const float* present, const int* a_inc_g, const int* a_exc_g,
    const float* any_anchor, float* best, int* idx, float* second,
    float* raw, float jitter_scale, long long p, long long n, int nrules,
    int r_width, int t_width, int a_width, int g_width, int pbase, int noff,
    int variant, long long batch, int lanes, void* stream) {
  if (batch < 0) return (int)cudaErrorInvalidValue;
  return launch_variant(price, base, neg_boost, validf, cand_g, stick,
                        prev_slot, prev_state, taken, present, a_inc_g,
                        a_exc_g, any_anchor, best, idx, second, raw,
                        jitter_scale, p, n, nrules, r_width, t_width,
                        a_width, g_width, pbase, noff, variant, batch, lanes,
                        stream);
}
