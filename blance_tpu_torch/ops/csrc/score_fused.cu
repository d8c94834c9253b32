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
// which gives its bound).  Design: one 256-thread block per row, like min2.cu.
// The row's id columns (prev_state, taken, the anchors' group ids and
// presence) are loaded once into shared memory; the [N] vectors stream
// through coalesced.  No tensor cores: the work is compares and adds.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

#include "min2_block.cuh"

struct Args {
  const float* price;      // [n]
  const float* base;       // [n]
  const float* neg_boost;  // [n]
  const float* validf;     // [n]
  const int* cand_g;       // [2*nrules or 1, n]
  const float* stick;      // [p]
  const int* prev_slot;    // [p]
  const int* prev_state;   // [p, r_width]
  const int* taken;        // [p, t_width]
  const float* present;    // [p, a_width]
  const int* a_inc_g;      // [p, g_width]
  const int* a_exc_g;      // [p, g_width]
  const float* any_anchor; // [p]
  float* best;
  int* idx;
  float* second;
  float* raw;
  float jitter_scale;
  int n, nrules, r_width, t_width, a_width, g_width, pbase, noff;
};

__global__ void __launch_bounds__(kThreads) fused_score_min2_kernel(Args a) {
  extern __shared__ int smem[];
  const int row = blockIdx.x;
  int* s_pstate = smem;                       // r_width
  int* s_taken = s_pstate + a.r_width;        // t_width
  int* s_inc = s_taken + a.t_width;           // g_width
  int* s_exc = s_inc + a.g_width;             // g_width
  float* s_present = reinterpret_cast<float*>(s_exc + a.g_width);  // a_width

  const long long r64 = row;
  for (int k = threadIdx.x; k < a.r_width; k += kThreads)
    s_pstate[k] = a.prev_state[r64 * a.r_width + k];
  for (int k = threadIdx.x; k < a.t_width; k += kThreads)
    s_taken[k] = a.taken[r64 * a.t_width + k];
  for (int k = threadIdx.x; k < a.g_width; k += kThreads) {
    s_inc[k] = a.a_inc_g[r64 * a.g_width + k];
    s_exc[k] = a.a_exc_g[r64 * a.g_width + k];
  }
  for (int k = threadIdx.x; k < a.a_width; k += kThreads)
    s_present[k] = a.present[r64 * a.a_width + k];
  __syncthreads();

  const float stick = a.stick[row];
  const int pslot = a.prev_slot[row];
  const bool gate = a.any_anchor[row] > 0.0f;
  const uint32_t pi_term = (uint32_t)(a.pbase + row) * 2654435761u;

  const float inf = __int_as_float(0x7f800000);
  Min2 m{inf, kEmpty, inf};
  for (int j = threadIdx.x; j < a.n; j += kThreads) {
    const int g = a.noff + j;
    const float nb = a.neg_boost[j];
    float s = a.base[j] + (nb > 0.0f ? fmaxf(nb, stick) : 0.0f);
    s = s - 0.01f * (pslot == g ? 1.0f : 0.0f);
    bool sticky = false;
    for (int r = 0; r < a.r_width; ++r) sticky |= (s_pstate[r] == g);
    s = s - stick * (sticky ? 1.0f : 0.0f);
    if (a.nrules > 0) {
      float pen = 1.0e6f;
      for (int i = 0; i < a.nrules; ++i) {
        const int cinc = a.cand_g[(long long)i * a.n + j];
        const int cexc = a.cand_g[(long long)(a.nrules + i) * a.n + j];
        bool sat = true;
        for (int ai = 0; ai < a.a_width; ++ai) {
          const int col = ai * a.nrules + i;
          const bool inc_same = s_inc[col] == cinc;
          const bool exc_same = s_exc[col] == cexc;
          sat = sat && ((s_present[ai] <= 0.0f) || (inc_same && !exc_same));
        }
        if (sat) pen = fminf(pen, (float)i * 1.0e4f);
      }
      s = s + (gate ? pen : 0.0f);
    }
    bool tk = false;
    for (int t = 0; t < a.t_width; ++t) tk |= (s_taken[t] == g);
    s = s + 1.0e9f * ((tk || a.validf[j] == 0.0f) ? 1.0f : 0.0f);
    const uint32_t h = (pi_term + (uint32_t)g * 40503u) & 0xFFFFu;
    s = fmaf(a.jitter_scale, (float)h / 65536.0f, s);
    push(m, s + a.price[j], j);
  }
  m = block_reduce(m);
  if (threadIdx.x == 0) {
    a.best[row] = m.best;
    a.idx[row] = m.idx;
    a.second[row] = m.second;
    a.raw[row] = m.best - a.price[m.idx];
  }
}

}  // namespace

// Shapes as in Args; every array row-major contiguous.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int blance_fused_score_min2(
    const float* price, const float* base, const float* neg_boost,
    const float* validf, const int* cand_g, const float* stick,
    const int* prev_slot, const int* prev_state, const int* taken,
    const float* present, const int* a_inc_g, const int* a_exc_g,
    const float* any_anchor, float* best, int* idx, float* second,
    float* raw, float jitter_scale, long long p, long long n, int nrules,
    int r_width,
    int t_width, int a_width, int g_width, int pbase, int noff,
    void* stream) {
  if (p <= 0) return 0;
  if (n <= 0 || n > INT_MAX || p > INT_MAX) return (int)cudaErrorInvalidValue;
  Args a{price, base, neg_boost, validf, cand_g, stick, prev_slot,
         prev_state, taken, present, a_inc_g, a_exc_g, any_anchor,
         best, idx, second, raw, jitter_scale, (int)n, nrules, r_width, t_width,
         a_width, g_width, pbase, noff};
  const size_t smem = sizeof(int) * (size_t)(r_width + t_width + 2 * g_width)
                      + sizeof(float) * (size_t)a_width;
  fused_score_min2_kernel<<<(unsigned)p, kThreads, smem,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
