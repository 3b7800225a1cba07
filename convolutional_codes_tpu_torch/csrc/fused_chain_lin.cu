// Fused Monte-Carlo Viterbi chain kernel for Hopper (sm_90a) with
// fast_demap's linear distances (AWGN, soft and snap-then-distance), 48
// instances: a library of its own so that it builds beside fused_chain.cu.
// The kernel body is fused_chain.cuh.
#include "fused_chain.cuh"

namespace {

template <int S, int M>
void launch_chain_lin(int snap, dim3 grid, int* out, const ChainParams& p,
                      cudaStream_t stream) {
  if (snap)
    mc_chain_kernel<S, M, kSnapLin><<<grid, kThreads, 0, stream>>>(out, p);
  else
    mc_chain_kernel<S, M, kSoftLin><<<grid, kThreads, 0, stream>>>(out, p);
}

}  // namespace

extern "C" {

// cc_mc_chain (fused_chain.cu) on the AWGN channel with the linear form
// of fast_demap: ci, cq, pe2 [M] float32 (ops/fused_chain.lin_params).
// Returns cudaGetLastError().
int cc_mc_chain_lin(int* out, int B, int Bt, int nsteps, unsigned seed, float sigma,
                    int snap, int K, int L, int T, int symlen, const int* esym_prev,
                    const float* points, const unsigned* polys, unsigned qmask,
                    float inv_nd, const float* ci, const float* cq, const float* pe2,
                    cudaStream_t stream) {
  ChainParams p;
  if (!ci || !cq || !pe2 ||
      !init_chain_params(p, B, Bt, nsteps, seed, sigma, 0u, K, L, T, symlen, esym_prev,
                         points, polys, qmask, inv_nd, ci, cq, pe2))
    return cudaErrorInvalidValue;
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  const dim3 grid((B + kThreads - 1) / kThreads);
#define CC_LAUNCH_CHAIN(S_, M_) launch_chain_lin<S_, M_>(snap, grid, out, p, stream)
  CC_DISPATCH(S, M, CC_LAUNCH_CHAIN)
#undef CC_LAUNCH_CHAIN
  return (int)cudaGetLastError();
}

}  // extern "C"
