// The auction score of one (row, column) cell, shared by score_fused.cu
// (the score fused with the priced min2) and score_write.cu (the matrix
// engine's [P, N] score): the launch arguments, a row's staged words, a
// column's terms, the score itself, the staging of a block's rows, a
// batch's offsets and the shapes 32-bit indexing holds.  Included once
// per translation unit, inside its anonymous namespace, after
// min2_block.cuh.
#pragma once

constexpr int kDyn = -1;  // template width read from Args at run time

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
  int p, n, nrules, r_width, t_width, a_width, g_width, pbase, noff;
};

// A row's staged terms, in 32-bit words: stick and stick * 0 (float
// bits), prev_slot, the hash's row term, the rule gate, then R prev_state
// ids, T taken ids, nrules * A include ids and as many exclude ids
// (anchor-major), padded to whole 16-byte words.
constexpr int kHead = 5;
__host__ __device__ constexpr int row_words(int nr, int r, int t, int a) {
  return (kHead + r + t + 2 * nr * a + 3) / 4 * 4;
}

// One column's terms, loaded once per chunk.
template <int kNR>
struct Col {
  float base, nb, price;
  float badv;     // 1e9 where validf == 0, else 0: the forbidden term
  int g;
  uint32_t hcol;  // g * 40503, the hash's column term
  int cinc[kNR > 0 ? kNR : 1];
  int cexc[kNR > 0 ? kNR : 1];
};

// kPriced false: the score write, which has no price (c.price = 0).
template <int kNR, bool kPriced = true>
__device__ __forceinline__ Col<kNR> load_col(const Args& a, int j) {
  Col<kNR> c;
  c.base = __ldg(a.base + j);
  c.nb = __ldg(a.neg_boost + j);
  c.price = kPriced ? __ldg(a.price + j) : 0.0f;
  c.badv = __ldg(a.validf + j) == 0.0f ? 1.0e9f : 0.0f;
  c.g = a.noff + j;
  c.hcol = (uint32_t)c.g * 40503u;
  if constexpr (kNR > 0) {
#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      c.cinc[i] = __ldg(a.cand_g + i * a.n + j);
      c.cexc[i] = __ldg(a.cand_g + (kNR + i) * a.n + j);
    }
  }
  return c;
}

// The score of one cell before its price; w is the row's staged words
// (registers in a fixed-width instantiation, shared memory in the
// runtime one).  Term order as the reference kernel, or with
// kMatrixOrder as the matrix engine's build (plan/tensor.py
// _matrix_score), which subtracts the same-ordinal bonus before it adds
// the boost: the two sums round differently where a node's weight is
// negative and the column is the row's previous node.
template <bool kMatrixOrder, int kNR>
__device__ __forceinline__ float score(const Args& a, const int* w,
                                       const Col<kNR>& c, int j, int nr,
                                       int rw, int tw, int aw) {
  const float stick = __int_as_float(w[0]);
  const float boost = c.nb > 0.0f ? fmaxf(c.nb, stick) : 0.0f;
  const float bonus = 0.01f * (w[2] == c.g ? 1.0f : 0.0f);
  float s = kMatrixOrder ? (c.base - bonus) + boost : (c.base + boost) - bonus;
  bool sticky = false;
#pragma unroll
  for (int r = 0; r < rw; ++r) sticky |= (w[kHead + r] == c.g);
  // stick * (0 or 1), the product taken once per row
  s = s - (sticky ? stick : __int_as_float(w[1]));
  if (nr > 0) {
    const int* inc = w + kHead + rw + tw;
    const int* exc = inc + nr * aw;
    float pen = 1.0e6f;
#pragma unroll
    for (int i = 0; i < nr; ++i) {
      int ci, ce;
      if constexpr (kNR > 0) {
        ci = c.cinc[i];
        ce = c.cexc[i];
      } else {
        ci = __ldg(a.cand_g + i * a.n + j);
        ce = __ldg(a.cand_g + (nr + i) * a.n + j);
      }
      bool sat = true;
#pragma unroll
      for (int ai = 0; ai < aw; ++ai)
        sat = sat && inc[ai * nr + i] == ci && exc[ai * nr + i] != ce;
      if (sat) pen = fminf(pen, (float)i * 1.0e4f);
    }
    s = s + (w[4] ? pen : 0.0f);
  }
  bool tk = false;
#pragma unroll
  for (int t = 0; t < tw; ++t) tk |= (w[kHead + rw + t] == c.g);
  s = s + (tk ? 1.0e9f : c.badv);  // = 1e9 * (tk || invalid), exactly
  // h / 65536 for the 16-bit hash h, exactly and without a conversion:
  // the float 128 + h * 2^-16 (h in the low mantissa bits: one byte
  // permute), minus 128.
  const uint32_t sum = (uint32_t)w[3] + c.hcol;
  const float frac = __uint_as_float(__byte_perm(sum, 0x43000000u, 0x7610))
                     - 128.0f;
  return fmaf(a.jitter_scale, frac, s);
}

// Writes row's staged words at w (zeros for a row past the end).
__device__ void stage_row(const Args& a, int* w, int row, int nr, int rw,
                          int tw, int aw, int nwords) {
  for (int k = 0; k < nwords; ++k) w[k] = 0;
  if (row >= a.p) return;
  w[0] = __float_as_int(a.stick[row]);
  w[1] = __float_as_int(a.stick[row] * 0.0f);
  w[2] = a.prev_slot[row];
  w[3] = (int)((uint32_t)(a.pbase + row) * 2654435761u);
  for (int r = 0; r < rw; ++r) w[kHead + r] = a.prev_state[row * rw + r];
  for (int t = 0; t < tw; ++t) w[kHead + rw + t] = a.taken[row * tw + t];
  if (nr == 0) return;
  int* inc = w + kHead + rw + tw;
  int* exc = inc + nr * aw;
  int np = 0;
  for (int ai = 0; ai < a.a_width; ++ai) {
    if (a.present[row * a.a_width + ai] <= 0.0f) continue;
    for (int i = 0; i < nr; ++i) {
      inc[np * nr + i] = a.a_inc_g[row * a.g_width + ai * nr + i];
      exc[np * nr + i] = a.a_exc_g[row * a.g_width + ai * nr + i];
    }
    ++np;
  }
  for (int ai = np; ai < aw && np > 0; ++ai) {
    for (int i = 0; i < nr; ++i) {
      inc[ai * nr + i] = inc[i];
      exc[ai * nr + i] = exc[i];
    }
  }
  w[4] = (a.any_anchor[row] > 0.0f && np > 0) ? 1 : 0;
}

// A batch of problems (the fleet tier) stacks B same-shaped problems in
// every array, and the launch puts the problem on blockIdx.y: problem b's
// block reads its own [n] vectors and [p, ...] row terms and writes its
// own [p] outputs, so a row tile never straddles two problems, and the
// hash sees the problem's own row and column ids.  The one-problem launch
// is its own kernel, which never offsets.  The score write has no price
// and no min2 outputs (null): they stay null.
template <class T>
__device__ __forceinline__ T* shift(T* ptr, long long off) {
  return ptr ? ptr + off : ptr;
}

__device__ __forceinline__ Args for_problem(Args a, long long b) {
  const long long n = a.n, p = a.p;
  const long long cand_rows = a.nrules > 0 ? 2LL * a.nrules : 1;
  a.price = shift(a.price, b * n);
  a.base += b * n;
  a.neg_boost += b * n;
  a.validf += b * n;
  a.cand_g += b * cand_rows * n;
  a.stick += b * p;
  a.prev_slot += b * p;
  a.prev_state += b * p * a.r_width;
  a.taken += b * p * a.t_width;
  a.present += b * p * a.a_width;
  a.a_inc_g += b * p * a.g_width;
  a.a_exc_g += b * p * a.g_width;
  a.any_anchor += b * p;
  a.best = shift(a.best, b * p);
  a.idx = shift(a.idx, b * p);
  a.second = shift(a.second, b * p);
  a.raw = shift(a.raw, b * p);
  return a;
}

// Whether the kernels' 32-bit index arithmetic holds these shapes (the
// score write's output offsets are 64-bit, so P * N may pass it).
bool shapes_fit(long long p, long long n, int nrules, int r_width,
                int t_width, int a_width, int g_width, long long batch) {
  long long widest = 1;
  const int widths[] = {r_width, t_width, a_width, g_width};
  for (int w : widths) widest = w > widest ? w : widest;
  return n > 0 && n <= INT_MAX && p <= INT_MAX && nrules >= 0 &&
         p * widest <= INT_MAX && (2LL * nrules + 1) * n <= INT_MAX &&
         batch <= 65535;
}
