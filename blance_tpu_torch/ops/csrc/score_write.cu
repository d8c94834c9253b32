// The matrix engine's [P, N] score in one pass: ops/score_fused.py
// score_write, which plan/tensor.py _matrix_score calls on the card.
//
// Replaces no TPU kernel.  The reference builds this matrix in one pass
// that XLA fuses; the port's eager build ran some 25 ops a row chunk
// that streamed float64 temporaries through HBM.  The kernel
// (score_write.cuh) evaluates score_cell.cuh's score, the fused
// kernel's, in the matrix build's term order (the same-ordinal bonus
// before the boost) and stores it, so it is bound by its 4-byte store a
// cell: 1.19 ms at [100 000, 10 000] at 3.35 TB/s.
//
// Lanes of a group take consecutive columns of a row, so every store of
// a warp is one 128-byte line; each group owns kWriteRows rows and each
// lane two columns of a chunk, so a column's terms serve kWriteRows
// cells and a row's staged words two.  Groups are as wide as the rows
// need, 32 to 256 lanes (write_log_lanes), so narrow rows (the fleet's
// N = 64) still fill the block.  The rows' terms are staged once a block
// in shared memory, as the fused kernel stages them; the widths (nrules,
// R, T, A) are template parameters in the fused kernel's instantiations
// (ops/score_fused.py FUSED_VARIANTS), which this library holds; the one
// of runtime widths, for any other shape, is score_write_any.cu.  Output
// offsets are 64-bit: P * N may pass INT_MAX.  A batch of same-shaped
// problems (the fleet tier) is one launch, the problem on blockIdx.y.
//
// Each is a library of its own, apart from score_fused.cu's fused
// instantiations, so a matrix engine's first plan builds min2.cu and
// only the write its widths need: the runtime-width instantiation takes
// most of the build time (PERF.md).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

#include "min2_block.cuh"
#include "score_cell.cuh"
#include "score_write.cuh"

int launch_fixed(int variant, const Args& a, float* out, int b,
                 cudaStream_t s) {
  switch (variant) {
    case 0: return launch_write<1, 1, 2, 2>(a, out, b, s);
    case 1: return launch_write<0, 1, 1, 0>(a, out, b, s);
    case 2: return launch_write<0, 2, 1, 0>(a, out, b, s);
    case 3: return launch_write<1, 2, 3, 3>(a, out, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The matrix engine's unpriced score of ``batch`` problems (1 for one
// problem) into out [batch, p, n], every input with a leading [batch]
// axis; shapes and variant as for blance_fused_score_min2, the variant
// one of the fixed-width ids 0-3.
extern "C" int blance_score_write(
    const float* base, const float* neg_boost, const float* validf,
    const int* cand_g, const float* stick, const int* prev_slot,
    const int* prev_state, const int* taken, const float* present,
    const int* a_inc_g, const int* a_exc_g, const float* any_anchor,
    float* out, float jitter_scale, long long p, long long n, int nrules,
    int r_width, int t_width, int a_width, int g_width, int pbase, int noff,
    int variant, long long batch, void* stream) {
  return write_entry(launch_fixed, base, neg_boost, validf, cand_g, stick,
                     prev_slot, prev_state, taken, present, a_inc_g,
                     a_exc_g, any_anchor, out, jitter_scale, p, n, nrules,
                     r_width, t_width, a_width, g_width, pbase, noff,
                     variant, batch, stream);
}
