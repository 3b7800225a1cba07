// Frames entry of the sequential Monte-Carlo kernels: writes, for given
// global frame ids, the frames that stack_mc.cu and fano_mc.cu generate
// in-thread (the shared gen_frame of sequential.cuh).  It is the CUDA
// counterpart of ops/mc_datagen.frames_host and is used by the checks only,
// so that a plain decoder can decode exactly what a kernel decoded.  One
// thread per frame; bound by the hash and Box-Muller arithmetic.
#define CC_SEQ_MAX_SYMLEN 8   // every width the JAX package takes (up to 256 points)
#include "sequential.cuh"

namespace {

__global__ void __launch_bounds__(CC_SEQ_THREADS)
seq_frames_kernel(int* __restrict__ bits, float* __restrict__ fsyms, int* __restrict__ isyms,
                  const int* __restrict__ gids, int N, const __grid_constant__ SeqParams p) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t per = (size_t)p.T * (p.soft ? p.M : 1);
  gen_frame(p, (unsigned)gids[n], p.soft ? fsyms + n * per : nullptr,
            p.soft ? nullptr : isyms + n * per, 1, bits + (size_t)n * p.T);
}

}  // namespace

extern "C" {

// bits [N, T] int32; syms [N, T, M] float32 (soft) or [N, T] int32 (BSC);
// gids [N] int32.  Host arrays: points [M, 2] float32, polys [symlen]
// uint32.  Returns cudaGetLastError().
int cc_seq_frames(int* bits, void* syms, const int* gids, int N, unsigned seed, float param,
                  int soft, int snap, int K, int L, int T, int symlen, const float* points,
                  const unsigned* polys, unsigned qmask, float inv_nd, cudaStream_t stream) {
  SeqParams p;
  const int bad = fill_seq_params(&p, seed, param, soft, snap, K, L, T, symlen, points,
                                  polys, qmask, inv_nd);
  if (bad || N <= 0) return bad ? bad : (int)cudaErrorInvalidValue;
  const dim3 grid((N + CC_SEQ_THREADS - 1) / CC_SEQ_THREADS);
  seq_frames_kernel<<<grid, CC_SEQ_THREADS, 0, stream>>>(
      bits, (float*)syms, (int*)syms, gids, N, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
