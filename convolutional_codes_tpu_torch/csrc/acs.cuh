// Shared device code of the Viterbi kernels: the radix-2 add-compare-select
// step on a per-thread metric array, and the (S, M) template dispatch.
//
// One thread owns one lane (kernels 3 and 6).  Its S path metrics live in a
// per-thread array (registers up to S = 64).  The trellis butterfly is read
// by index: new state ns has predecessors 2j and 2j+1 (j = ns mod S/2), and
// the expected symbols of those two transitions come from the esym tables,
// which sit in the kernel's parameter block (constant bank) and are read at
// compile-time offsets because the state loop is fully unrolled.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_MAX_STATES 256
#define CC_MAX_POINTS 8

// Hard-decision saturation (binary-symmetric-channel/viterbi-decoder.c:127).
#define CC_HARD_SAT 65280.0f

struct TrellisTables {
  unsigned char esym0[CC_MAX_STATES];  // esym_prev[ns, 0]
  unsigned char esym1[CC_MAX_STATES];  // esym_prev[ns, 1]
};

static inline void fill_trellis(TrellisTables* tt, const int* esym_prev, int S) {
  for (int s = 0; s < CC_MAX_STATES; ++s) {
    tt->esym0[s] = s < S ? (unsigned char)esym_prev[2 * s] : 0;
    tt->esym1[s] = s < S ? (unsigned char)esym_prev[2 * s + 1] : 0;
  }
}

// One trellis step src -> dst.  Strict-less compare: ties keep branch 0
// (the even predecessor).  Hard mode saturates both candidates at 0xFF00
// before the compare, as the reference does.  The branch metric of each
// transition is read from the thread's column of shared memory, bmcol[e
// STRIDE]: one load at a computed address (a pick from registers took M-1
// compares and selects).  words[w] receives bit (s % 32) = decision of new
// state s = 32 w + (s % 32).
template <int S, int STRIDE>
__device__ __forceinline__ void acs_step_smem(const float (&src)[S], float (&dst)[S],
                                              const float* bmcol, bool hard,
                                              const TrellisTables& tt,
                                              unsigned (&words)[(S + 31) / 32]) {
  constexpr int NW = (S + 31) / 32;
  constexpr int PER = S < 32 ? S : 32;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ns = w * 32 + i;
      const int j = ns & (S / 2 - 1);
      float c0 = src[2 * j] + bmcol[tt.esym0[ns] * STRIDE];
      float c1 = src[2 * j + 1] + bmcol[tt.esym1[ns] * STRIDE];
      if (hard) {
        c0 = fminf(c0, CC_HARD_SAT);
        c1 = fminf(c1, CC_HARD_SAT);
      }
      const bool d = c1 < c0;
      dst[ns] = d ? c1 : c0;
      word |= (unsigned)d << i;
    }
    words[w] = word;
  }
}

// The same step with each transition's branch metric bm(e) computed where
// it is read (kernel 6 for M = 16-256, whose column of M metrics a thread
// would not fit in shared memory): bm is a function of the expected symbol
// that gives the float the column would hold.
template <int S, class BM>
__device__ __forceinline__ void acs_step_fn(const float (&src)[S], float (&dst)[S], BM bm,
                                            bool hard, const TrellisTables& tt,
                                            unsigned (&words)[(S + 31) / 32]) {
  constexpr int NW = (S + 31) / 32;
  constexpr int PER = S < 32 ? S : 32;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ns = w * 32 + i;
      const int j = ns & (S / 2 - 1);
      float c0 = src[2 * j] + bm((unsigned)tt.esym0[ns]);
      float c1 = src[2 * j + 1] + bm((unsigned)tt.esym1[ns]);
      if (hard) {
        c0 = fminf(c0, CC_HARD_SAT);
        c1 = fminf(c1, CC_HARD_SAT);
      }
      const bool d = c1 < c0;
      dst[ns] = d ? c1 : c0;
      word |= (unsigned)d << i;
    }
    words[w] = word;
  }
}

// First state with the least metric (strict-less scan from state 0).
template <int S>
__device__ __forceinline__ unsigned argmin_state(const float (&m)[S]) {
  float best = m[0];
  unsigned cur = 0;
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (m[s] < best) {
      best = m[s];
      cur = (unsigned)s;
    }
  }
  return cur;
}

// The expected symbol of every K-bit register (polynomial 0 at the MSB,
// with the compat quirk: models/trellis.py effective_parity_u64), symlen
// bits each, packed into 64 bits where 2^K symlen <= 64; 0 elsewhere.
static inline unsigned long long pack_esym_table(int K, int symlen, const unsigned* polys,
                                                 unsigned qmask, int* packed) {
  unsigned long long tab = 0;
  *packed = (1 << K) * symlen <= 64;
  if (!*packed) return 0;
  for (unsigned reg = 0; reg < (1u << K); ++reg) {
    unsigned esym = 0;
    for (int n = 0; n < symlen; ++n) {
      const unsigned x = reg & polys[n];
      unsigned bit = (unsigned)__builtin_parity(x);
      if (qmask) bit &= 1u - (unsigned)__builtin_parity(x & qmask);
      esym = (esym << 1) | bit;
    }
    tab |= (unsigned long long)esym << (reg * symlen);
  }
  return tab;
}

// Calls FN<S, M>(args...) for a runtime (S, M) with S in {2..256} (powers
// of two) and M in {2, 4, 8}; evaluates to cudaErrorInvalidValue otherwise.
#define CC_DISPATCH_M(S_, M, LAUNCH)       \
  switch (M) {                             \
    case 2: LAUNCH(S_, 2); break;          \
    case 4: LAUNCH(S_, 4); break;          \
    case 8: LAUNCH(S_, 8); break;          \
    default: return cudaErrorInvalidValue; \
  }

// The same with M in {2, 4, 8, 16}: for the stream ACS (kernels 1 and 4),
// which holds no per-thread array of M, so rate-1/4 codes (16 points) take
// it as the JAX package's ACS kernels take any M.
#define CC_DISPATCH_M16(S_, M, LAUNCH)     \
  switch (M) {                             \
    case 2: LAUNCH(S_, 2); break;          \
    case 4: LAUNCH(S_, 4); break;          \
    case 8: LAUNCH(S_, 8); break;          \
    case 16: LAUNCH(S_, 16); break;        \
    default: return cudaErrorInvalidValue; \
  }

#define CC_DISPATCH_S(S, M, LAUNCH, BY_M)              \
  switch (S) {                                         \
    case 2: BY_M(2, M, LAUNCH); break;                 \
    case 4: BY_M(4, M, LAUNCH); break;                 \
    case 8: BY_M(8, M, LAUNCH); break;                 \
    case 16: BY_M(16, M, LAUNCH); break;               \
    case 32: BY_M(32, M, LAUNCH); break;               \
    case 64: BY_M(64, M, LAUNCH); break;               \
    case 128: BY_M(128, M, LAUNCH); break;             \
    case 256: BY_M(256, M, LAUNCH); break;             \
    default: return cudaErrorInvalidValue;             \
  }

// Calls FN<S, 0>(args...), the instance for M given at run time, for a
// runtime S in {2..256} (the kernels' path for large M).
#define CC_DISPATCH_RUNTIME_M(S_, M, LAUNCH) LAUNCH(S_, 0)

#define CC_DISPATCH(S, M, LAUNCH) CC_DISPATCH_S(S, M, LAUNCH, CC_DISPATCH_M)
#define CC_DISPATCH16(S, M, LAUNCH) CC_DISPATCH_S(S, M, LAUNCH, CC_DISPATCH_M16)
