// Viterbi add-compare-select and traceback kernels for Hopper (sm_90a).
//
// Replace the TPU kernels convolutional_codes_tpu/ops/viterbi_pallas.py
// `_acs_kernel` (:86, entry acs_forward_pallas :157) and `_traceback_kernel`
// (:207, entry traceback_pallas :232).
//
// What bounds them on the H100: each frame is a serial recurrence over T
// trellis steps of about 8 S operations (two branch-metric selects, two
// adds, a compare, a select, a bit pack) on S metrics of live state,
// against M floats in and ceil(S/32) words out per frame-step.  At small S
// (code 0, S = 4) that is few operations per byte, and both kernels run
// at the device-memory bound (about 2.3 TB/s of 3.35 measured at
// B = 262,144, PERF.md); as S grows the ACS work grows with S while the
// bytes grow with S/32, and from S = 128 the metric arrays spill to local
// memory, whose traffic then bounds the ACS kernel.
//
// Design: one thread per frame, so the batch axis B maps to threads and
// every [T, M, B] load and [T, nwords, B] store is coalesced along B.  The
// metric arrays are templated on S (registers up to S = 64), ping-ponged
// between two arrays with the time loop unrolled by two so that no copy is
// needed.  The TPU kernel's one-hot matmul selection is gone: predecessors
// and expected symbols are read by butterfly index.  The traceback kernel
// also takes the end-state argmin (strict-less scan from state 0, first
// state wins ties, as jnp.argmin), so no library argmin decides a tie.
#include "acs.cuh"

namespace {

constexpr int kThreads = 128;

// One time step of the ACS kernel: load the M branch metrics of step t,
// run the butterfly src -> dst, store the packed decision words.
template <int S, int M>
__device__ __forceinline__ void acs_time_step(const float (&src)[S], float (&dst)[S],
                                              const float* __restrict__ dists,
                                              int* __restrict__ dec, int t, size_t Bs,
                                              int b, bool hard,
                                              const TrellisTables& tt) {
  constexpr int NW = (S + 31) / 32;
  float bm[M];
  unsigned words[NW];
#pragma unroll
  for (int e = 0; e < M; ++e) bm[e] = dists[((size_t)t * M + e) * Bs + b];
  acs_step<S, M>(src, dst, bm, hard, tt, words);
#pragma unroll
  for (int w = 0; w < NW; ++w) dec[((size_t)t * NW + w) * Bs + b] = (int)words[w];
}

template <int S, int M>
__global__ void __launch_bounds__(kThreads)
acs_kernel(const float* __restrict__ dists, const float* __restrict__ init,
           float* __restrict__ fm, int* __restrict__ dec, int T, int B, int hard,
           const __grid_constant__ TrellisTables tt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  float ma[S], mb[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ma[s] = init[s * Bs + b];

  int t = 0;
  for (; t + 1 < T; t += 2) {
    acs_time_step<S, M>(ma, mb, dists, dec, t, Bs, b, hard, tt);
    acs_time_step<S, M>(mb, ma, dists, dec, t + 1, Bs, b, hard, tt);
  }
  if (t < T) {
    acs_time_step<S, M>(ma, mb, dists, dec, t, Bs, b, hard, tt);
#pragma unroll
    for (int s = 0; s < S; ++s) fm[s * Bs + b] = mb[s];
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) fm[s * Bs + b] = ma[s];
  }
}

__global__ void __launch_bounds__(kThreads)
traceback_kernel(const int* __restrict__ dec, const float* __restrict__ fm,
                 int* __restrict__ bits, float* __restrict__ min_metric,
                 int T, int B, int S, int K, int nwords) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  float best = fm[b];
  unsigned cur = 0;
  for (int s = 1; s < S; ++s) {
    const float v = fm[s * Bs + b];
    if (v < best) {
      best = v;
      cur = (unsigned)s;
    }
  }
  min_metric[b] = best;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  for (int t = T - 1; t >= 0; --t) {
    const unsigned word = (unsigned)dec[((size_t)t * nwords + (cur >> 5)) * Bs + b];
    const unsigned survivor = (word >> (cur & 31u)) & 1u;
    bits[(size_t)t * Bs + b] = (int)(cur >> (K - 2));
    cur = ((cur & half_mask) << 1) | survivor;
  }
}

}  // namespace

extern "C" {

// dists [T, M, B] f32, init [S, B] f32 -> fm [S, B] f32, dec [T, nwords, B]
// i32.  esym_prev: host [S, 2] int32.  Returns cudaGetLastError().
int cc_acs_forward(const float* dists, const float* init, float* fm, int* dec,
                   int T, int M, int B, int S, int hard, const int* esym_prev,
                   cudaStream_t stream) {
  if (T <= 0 || B <= 0) return cudaErrorInvalidValue;
  TrellisTables tt;
  fill_trellis(&tt, esym_prev, S);
  const dim3 grid((B + kThreads - 1) / kThreads);
#define CC_LAUNCH_ACS(S_, M_) \
  acs_kernel<S_, M_><<<grid, kThreads, 0, stream>>>(dists, init, fm, dec, T, B, hard, tt)
  CC_DISPATCH(S, M, CC_LAUNCH_ACS)
#undef CC_LAUNCH_ACS
  return (int)cudaGetLastError();
}

// dec [T, nwords, B] i32, fm [S, B] f32 -> bits [T, B] i32, min_metric [B].
int cc_traceback(const int* dec, const float* fm, int* bits, float* min_metric,
                 int T, int B, int S, int K, int nwords, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S < 2 || S > CC_MAX_STATES) return cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads);
  traceback_kernel<<<grid, kThreads, 0, stream>>>(dec, fm, bits, min_metric, T, B, S,
                                                  K, nwords);
  return (int)cudaGetLastError();
}

}  // extern "C"
