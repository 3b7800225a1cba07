// Fused Monte-Carlo Viterbi chain kernel for Hopper (sm_90a): the BSC and
// the exact AWGN demappers (soft, snap-then-distance), 72 instances.  The
// kernel body is fused_chain.cuh; fast_demap's modes are fused_chain_lin.cu.
#include "fused_chain.cuh"

namespace {

// sincosf against the pair sinf, cosf at theta = 2 pi u for the uniforms u
// of flat indices 0 .. n-1 (salt 2, hash base sbase), as the chain draws
// them: counts[0] += the arguments whose sines differ in any bit,
// counts[1] += those whose cosines do.
__global__ void __launch_bounds__(256)
sincos_check_kernel(unsigned long long* __restrict__ counts, unsigned n, unsigned sbase) {
  unsigned ds = 0, dc = 0;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float theta = kTwoPi * hash_uniform(i, sbase, kSalt2);
    const float s0 = sinf(theta), c0 = cosf(theta);
    float s1, c1;
    sincosf(theta, &s1, &c1);
    ds += __float_as_uint(s0) != __float_as_uint(s1);
    dc += __float_as_uint(c0) != __float_as_uint(c1);
  }
  atomicAdd(&counts[0], (unsigned long long)ds);
  atomicAdd(&counts[1], (unsigned long long)dc);
}

template <int S, int M>
void launch_chain(int mode, dim3 grid, int* out, const ChainParams& p, cudaStream_t stream) {
  if (mode == kBsc)
    mc_chain_kernel<S, M, kBsc><<<grid, kThreads, 0, stream>>>(out, p);
  else if (mode == kSoft)
    mc_chain_kernel<S, M, kSoft><<<grid, kThreads, 0, stream>>>(out, p);
  else
    mc_chain_kernel<S, M, kSnap><<<grid, kThreads, 0, stream>>>(out, p);
}

}  // namespace

extern "C" {

// out [2, B] int32 (bit errors, frame errors per lane).  flip_below: a BSC
// coded bit flips where its draw's 31-bit integer is below it
// (ops/fused_chain.flip_threshold).  Host arrays: esym_prev [S, 2]
// int32, points [M, 2] float32, polys [symlen] uint32.  Returns
// cudaGetLastError().
int cc_mc_chain(int* out, int B, int Bt, int nsteps, unsigned seed, float param,
                unsigned flip_below, int bsc, int snap, int K, int L, int T, int symlen,
                const int* esym_prev, const float* points, const unsigned* polys,
                unsigned qmask, float inv_nd, cudaStream_t stream) {
  ChainParams p;
  if (!init_chain_params(p, B, Bt, nsteps, seed, param, flip_below, K, L, T, symlen,
                         esym_prev, points, polys, qmask, inv_nd, nullptr, nullptr, nullptr))
    return cudaErrorInvalidValue;
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  const int mode = bsc ? kBsc : (snap ? kSnap : kSoft);
  const dim3 grid((B + kThreads - 1) / kThreads);
#define CC_LAUNCH_CHAIN(S_, M_) launch_chain<S_, M_>(mode, grid, out, p, stream)
  CC_DISPATCH(S, M, CC_LAUNCH_CHAIN)
#undef CC_LAUNCH_CHAIN
  return (int)cudaGetLastError();
}

// counts [2] uint64 (zeroed by the caller): sincos_check_kernel over n
// arguments from hash base sbase.  Returns cudaGetLastError().
int cc_sincos_check(unsigned long long* counts, unsigned n, unsigned sbase,
                    cudaStream_t stream) {
  sincos_check_kernel<<<1024, 256, 0, stream>>>(counts, n, sbase);
  return (int)cudaGetLastError();
}

}  // extern "C"
