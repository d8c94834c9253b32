// The score write's kernel and its launch, shared by score_write.cu (the
// fixed-width instantiations) and score_write_any.cu (runtime widths):
// see score_write.cu.  Included once per translation unit, inside its
// anonymous namespace, after score_cell.cuh; the includer's launcher
// passes write_entry the instantiation its variant id names.

// The score write: problem blockIdx.y, a group of 1 << log_lanes lanes
// per kWriteRows rows, kThreads >> log_lanes groups a block.  The
// block's rows are staged as in fused_tile; lane q of a group takes the
// columns q and q + L of each chunk of 2L, loads their terms once, and
// stores both cells of every row of its group.  The offsets are 64-bit
// from the problem's first cell on.
constexpr int kWriteRows = 16;

template <int kNR, int kR, int kT, int kA>
__global__ void __launch_bounds__(kThreads)
score_write_kernel(Args problems, float* out, int log_lanes) {
  const Args a = for_problem(problems, blockIdx.y);
  constexpr bool kFixed = kNR != kDyn;
  constexpr int kW = kFixed ? row_words(kNR, kR, kT, kA) : 4;
  const int nr = kFixed ? kNR : a.nrules;
  const int rw = kFixed ? kR : a.r_width;
  const int tw = kFixed ? kT : a.t_width;
  const int aw = kFixed ? kA : a.a_width;
  const int nwords = kFixed ? kW : row_words(nr, rw, tw, aw);
  const int lanes = 1 << log_lanes;
  const int rows = (kThreads >> log_lanes) * kWriteRows;
  extern __shared__ int4 smem4[];
  int* srow = reinterpret_cast<int*>(smem4);  // [rows][nwords]
  const int row0 = blockIdx.x * rows;
  for (int e = threadIdx.x; e < rows; e += kThreads)
    stage_row(a, srow + e * nwords, row0 + e, nr, rw, tw, aw, nwords);
  __syncthreads();

  const int first = (threadIdx.x >> log_lanes) * kWriteRows;
  const int q = threadIdx.x & (lanes - 1);
  const int nrow = min(kWriteRows, a.p - row0 - first);  // <= 0: none
  float* o = out + ((long long)blockIdx.y * a.p + row0 + first) * a.n;
  for (int j0 = q; j0 < a.n; j0 += 2 * lanes) {
    const int j1 = j0 + lanes;
    const Col<kFixed ? kNR : 0> c0 = load_col<kFixed ? kNR : 0, false>(a, j0);
    const Col<kFixed ? kNR : 0> c1 =
        load_col<kFixed ? kNR : 0, false>(a, j1 < a.n ? j1 : j0);
#pragma unroll
    for (int rr = 0; rr < kWriteRows; ++rr) {
      if (rr >= nrow) break;
      const int* w = srow + (first + rr) * nwords;
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
      float* orow = o + (long long)rr * a.n;
      orow[j0] = score<true>(a, kFixed ? v : w, c0, j0, nr, rw, tw, aw);
      if (j1 < a.n)
        orow[j1] = score<true>(a, kFixed ? v : w, c1, j1, nr, rw, tw, aw);
    }
  }
}

// Lanes a group for rows of n columns: two columns a lane, 32 to 256
// lanes, more where a block's staged rows would pass 48 KB; 0 if even
// 256 lanes (kWriteRows rows a block) cannot fit them.
int write_log_lanes(long long n, int nwords) {
  int log_lanes = 5;
  while (log_lanes < 8 && (2LL << log_lanes) < n) ++log_lanes;
  while (log_lanes <= 8 && sizeof(int) * (size_t)nwords * kWriteRows *
                               (kThreads >> log_lanes) > 48 * 1024)
    ++log_lanes;
  return log_lanes <= 8 ? log_lanes : 0;
}

template <int kNR, int kR, int kT, int kA>
int launch_write(const Args& a, float* out, int batch, cudaStream_t stream) {
  if (kNR != kDyn && (a.nrules != kNR || a.r_width != kR ||
                      a.t_width != kT || (kNR > 0 && a.a_width != kA)))
    return (int)cudaErrorInvalidValue;  // widths of another instantiation
  const int nwords = row_words(a.nrules, a.r_width, a.t_width,
                               a.nrules > 0 ? a.a_width : 0);
  const int log_lanes = write_log_lanes(a.n, nwords);
  if (log_lanes == 0) return (int)cudaErrorInvalidValue;
  const int rows = (kThreads >> log_lanes) * kWriteRows;
  const size_t smem = sizeof(int) * (size_t)rows * nwords;
  const dim3 grid((unsigned)(((long long)a.p + rows - 1) / rows), batch);
  score_write_kernel<kNR, kR, kT, kA><<<grid, kThreads, smem, stream>>>(
      a, out, log_lanes);
  return (int)cudaGetLastError();
}

// The launchers' shared front: 0 with nothing launched for an empty
// problem, an error for shapes the kernel refuses, else what
// ``launch(variant, args, out, batch, stream)`` returns.
template <class Launch>
int write_entry(Launch launch, const float* base, const float* neg_boost,
                const float* validf, const int* cand_g, const float* stick,
                const int* prev_slot, const int* prev_state,
                const int* taken, const float* present, const int* a_inc_g,
                const int* a_exc_g, const float* any_anchor, float* out,
                float jitter_scale, long long p, long long n, int nrules,
                int r_width, int t_width, int a_width, int g_width,
                int pbase, int noff, int variant, long long batch,
                void* stream) {
  if (p <= 0 || batch == 0) return 0;
  if (batch < 0 ||
      !shapes_fit(p, n, nrules, r_width, t_width, a_width, g_width, batch))
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, base, neg_boost, validf, cand_g, stick, prev_slot,
         prev_state, taken, present, a_inc_g, a_exc_g, any_anchor,
         nullptr, nullptr, nullptr, nullptr, jitter_scale, (int)p, (int)n,
         nrules, r_width, t_width, a_width, g_width, pbase, noff};
  return launch(variant, a, out, (int)batch, (cudaStream_t)stream);
}
