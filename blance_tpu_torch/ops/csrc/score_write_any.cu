// The score write (score_write.cu) for widths no fixed-width
// instantiation takes: the runtime-width instantiation alone, a library
// of its own, built on the first plan whose widths need it (the
// multiprimary model's R = 2, T = 2-4 without a rule).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

#include "min2_block.cuh"
#include "score_cell.cuh"
#include "score_write.cuh"

int launch_any(int variant, const Args& a, float* out, int b,
               cudaStream_t s) {
  switch (variant) {
    case -1: return launch_write<kDyn, kDyn, kDyn, kDyn>(a, out, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// blance_score_write for the variant id -1 (runtime widths).
extern "C" int blance_score_write_any(
    const float* base, const float* neg_boost, const float* validf,
    const int* cand_g, const float* stick, const int* prev_slot,
    const int* prev_state, const int* taken, const float* present,
    const int* a_inc_g, const int* a_exc_g, const float* any_anchor,
    float* out, float jitter_scale, long long p, long long n, int nrules,
    int r_width, int t_width, int a_width, int g_width, int pbase, int noff,
    int variant, long long batch, void* stream) {
  return write_entry(launch_any, base, neg_boost, validf, cand_g, stick,
                     prev_slot, prev_state, taken, present, a_inc_g,
                     a_exc_g, any_anchor, out, jitter_scale, p, n, nrules,
                     r_width, t_width, a_width, g_width, pbase, noff,
                     variant, batch, stream);
}
