// Shared device code of the Viterbi kernels: the radix-2 add-compare-select
// step on a per-thread metric array, and the (S, M) template dispatch.
//
// One thread owns one frame.  Its S path metrics live in a per-thread array
// (registers up to S = 64; S = 128/256 spill to local memory).  The trellis
// butterfly is read by index: new state ns has predecessors 2j and 2j+1
// (j = ns mod S/2), and the expected symbols of those two transitions come
// from the esym tables, which sit in the kernel's parameter block (constant
// bank) and are read at compile-time offsets because the state loop is
// fully unrolled.
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

// bm[es] without a dynamic register index (which would move bm to local
// memory): M-1 compare/selects.
template <int M>
__device__ __forceinline__ float pick(const float (&bm)[M], int es) {
  float r = bm[0];
#pragma unroll
  for (int e = 1; e < M; ++e) r = (es == e) ? bm[e] : r;
  return r;
}

// One trellis step src -> dst.  Strict-less compare: ties keep branch 0
// (the even predecessor).  Hard mode saturates both candidates at 0xFF00
// before the compare, as the reference does.  words[w] receives bit (s % 32)
// = decision of new state s = 32 w + (s % 32).
template <int S, int M>
__device__ __forceinline__ void acs_step(const float (&src)[S], float (&dst)[S],
                                         const float (&bm)[M], bool hard,
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
      float c0 = src[2 * j] + pick<M>(bm, tt.esym0[ns]);
      float c1 = src[2 * j + 1] + pick<M>(bm, tt.esym1[ns]);
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

// Calls FN<S, M>(args...) for a runtime (S, M) with S in {2..256} (powers
// of two) and M in {2, 4, 8}; evaluates to cudaErrorInvalidValue otherwise.
#define CC_DISPATCH_M(S_, M, LAUNCH)       \
  switch (M) {                             \
    case 2: LAUNCH(S_, 2); break;          \
    case 4: LAUNCH(S_, 4); break;          \
    case 8: LAUNCH(S_, 8); break;          \
    default: return cudaErrorInvalidValue; \
  }

#define CC_DISPATCH(S, M, LAUNCH)                      \
  switch (S) {                                         \
    case 2: CC_DISPATCH_M(2, M, LAUNCH); break;        \
    case 4: CC_DISPATCH_M(4, M, LAUNCH); break;        \
    case 8: CC_DISPATCH_M(8, M, LAUNCH); break;        \
    case 16: CC_DISPATCH_M(16, M, LAUNCH); break;      \
    case 32: CC_DISPATCH_M(32, M, LAUNCH); break;      \
    case 64: CC_DISPATCH_M(64, M, LAUNCH); break;      \
    case 128: CC_DISPATCH_M(128, M, LAUNCH); break;    \
    case 256: CC_DISPATCH_M(256, M, LAUNCH); break;    \
    default: return cudaErrorInvalidValue;             \
  }
