// Fused long-frame Monte-Carlo Viterbi kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel convolutional_codes_tpu/ops/fused_longframe.py
// `_mc_longframe_kernel` (:84, entry mc_longframe_viterbi :223).  Each
// thread owns one lane: an unterminated coded stream, decoded in nsteps
// overlap-save windows of Tw = Wn + 2W symbols (W-symbol halos on both
// sides of a Wn-symbol payload).  Window `win0 + step` covers the stream
// positions from (win0 + step) * Wn - W on, and the K-1 info bits before
// them seed the encoder register, so the halos replay the same bits and
// noise as the neighbouring windows.  Per symbol: the info bit from hash
// salt 0, the encoder with the compat quirk, then BSC flips of coded bit k
// from salt 1 + k, or Box-Muller AWGN from salts 1 and 2 and the soft (or
// snap-then-soft) demapper; then one ACS step from zero start metrics.
// After Tw steps: the first state of least metric, and the traceback from
// row Tw-1 down to row W, counting errors on the payload rows only.  The
// hash is sequential.cuh's coord_bits keyed by the global lane, so the
// counters do not depend on the CUDA block size.  Only the [2, lanes]
// counters (bit errors, windows with an error) are results.
//
// What bounds it on the H100: per symbol a lane does two or three hashes
// (plus log/sqrt/sin/cos for AWGN), the encoder, the demapper and about
// 8 S ACS operations, all dependent along t, and it stores ceil(S/32)
// decision words that the traceback reads back: Tw * ceil(S/32) words per
// lane and window (8.7 KB at K=3, 17.4 KB at K=7 for Tw = 2176), too many
// for registers or shared memory.  So the decisions go to a [Tw, nwords,
// lanes] device scratch that the wrapper allocates, laid out so that a
// warp's stores and loads are coalesced; everything else stays in
// registers (the S metrics; S >= 128 spills to local memory as in
// fused_chain.cu), and the info bits are regenerated from the hash in the
// traceback instead of being stored.  It is bound by instruction issue,
// with the scratch traffic second.
//
// Exactness: built with -fmad=false, strict-less compares, the same
// float32 expressions as the plain version; BSC runs carry no
// transcendental and match it bit for bit.
#include "acs.cuh"
#include "sequential.cuh"

namespace {

constexpr int kThreads = 128;

struct LongframeParams {
  TrellisTables tt;
  SeqParams s;    // seed, channel, constellation, encoder; L = Tw, T = Tw + K - 1
  int W, Wn, Tw, nsteps, win0, lanes;
};

// Info bit of lane `lane` at stream position `pos`.
__device__ __forceinline__ unsigned stream_bit(const SeqParams& p, unsigned lane,
                                               unsigned pos) {
  return coord_bits(lane, pos, p.seed, 0u) & 1u;
}

template <int M>
__device__ __forceinline__ void dist_vec(const SeqParams& p, float rxi, float rxq,
                                         float (&bm)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const float di = rxi - p.px[e], dq = rxq - p.py[e];
    bm[e] = ((di * di) + (dq * dq)) * p.inv_nd;
  }
}

// Branch metrics of the symbol at stream position pos, expected symbol esym.
template <int M>
__device__ __forceinline__ void branch_metrics(const SeqParams& p, unsigned lane, unsigned pos,
                                               unsigned esym, float (&bm)[M]) {
  if (!p.soft) {
    unsigned fmask = 0;
    for (int k = 0; k < p.symlen; ++k)
      fmask |= (unsigned)(coord_uniform(lane, pos, p.seed, seq_salt(1u + k)) < p.param) << k;
    const unsigned rx = esym ^ fmask;
#pragma unroll
    for (int e = 0; e < M; ++e) bm[e] = (float)__popc(rx ^ (unsigned)e);
    return;
  }
  const float u0 = coord_uniform(lane, pos, p.seed, seq_salt(1u));
  const float u1 = coord_uniform(lane, pos, p.seed, seq_salt(2u));
  const float r = sqrtf(-2.0f * logf(u0));
  const float theta = 6.28318530717958647692f * u1;
  dist_vec<M>(p, p.px[esym] + p.param * (r * cosf(theta)),
              p.py[esym] + p.param * (r * sinf(theta)), bm);
  if (p.snap) {  // nearest point by strict-less scan (first wins)
    float best = bm[0], sxi = p.px[0], sxq = p.py[0];
#pragma unroll
    for (int e = 1; e < M; ++e) {
      if (bm[e] < best) {
        best = bm[e];
        sxi = p.px[e];
        sxq = p.py[e];
      }
    }
    dist_vec<M>(p, sxi, sxq, bm);
  }
}

// Symbol row t of a window whose row 0 is stream position base: advance the
// encoder, draw the channel, run one ACS step src -> dst, store decisions.
template <int S, int M>
__device__ __forceinline__ void window_step(const LongframeParams& p, unsigned lane,
                                            unsigned base, int t, unsigned& reg,
                                            const float (&src)[S], float (&dst)[S],
                                            unsigned* __restrict__ scratch) {
  constexpr int NW = (S + 31) / 32;
  const unsigned pos = base + (unsigned)t;
  reg = (reg >> 1) | (stream_bit(p.s, lane, pos) << (p.s.K - 1));
  float bm[M];
  branch_metrics<M>(p.s, lane, pos, seq_esym(reg, p.s), bm);
  unsigned words[NW];
  acs_step<S, M>(src, dst, bm, !p.s.soft, p.tt, words);
#pragma unroll
  for (int w = 0; w < NW; ++w)
    scratch[((size_t)t * NW + w) * (size_t)p.lanes + lane] = words[w];
}

template <int S, int M>
__global__ void __launch_bounds__(kThreads)
mc_longframe_kernel(int* __restrict__ out, unsigned* __restrict__ scratch,
                    const __grid_constant__ LongframeParams p) {
  constexpr int NW = (S + 31) / 32;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.lanes) return;
  const unsigned lane = (unsigned)g;
  const int K = p.s.K;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  int errs = 0, werrs = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    // symbol row t is stream position base + t (mod 2^32, as the TPU
    // kernel's int32 positions wrap)
    const unsigned base = (unsigned)(p.win0 + step) * (unsigned)p.Wn - (unsigned)p.W;
    unsigned reg = 0;
    for (int j = 0; j < K - 1; ++j)   // the K-1 lead-in bits
      reg = (reg >> 1) | (stream_bit(p.s, lane, base - (unsigned)(K - 1 - j)) << (K - 1));
    float ma[S], mb[S];
#pragma unroll
    for (int s = 0; s < S; ++s) ma[s] = 0.0f;   // uniform start: the left halo warms up
    int t = 0;
    for (; t + 1 < p.Tw; t += 2) {
      window_step<S, M>(p, lane, base, t, reg, ma, mb, scratch);
      window_step<S, M>(p, lane, base, t + 1, reg, mb, ma, scratch);
    }
    unsigned cur;
    if (t < p.Tw) {
      window_step<S, M>(p, lane, base, t, reg, ma, mb, scratch);
      cur = argmin_state<S>(mb);
    } else {
      cur = argmin_state<S>(ma);
    }
    // rows below W only lead into the left halo: the walk stops at row W
    int err = 0;
    for (t = p.Tw - 1; t >= p.W; --t) {
      const unsigned word = scratch[((size_t)t * NW + (cur >> 5)) * (size_t)p.lanes + lane];
      if (t < p.W + p.Wn) err += (int)((cur >> (K - 2)) != stream_bit(p.s, lane, base + t));
      cur = ((cur & half_mask) << 1) | ((word >> (cur & 31u)) & 1u);
    }
    errs += err;
    werrs += err > 0;
  }
  out[g] = errs;
  out[(size_t)p.lanes + g] = werrs;
}

}  // namespace

extern "C" {

// out [2, lanes] int32 (bit errors, windows with an error, per lane);
// scratch [Tw, ceil(S/32), lanes] 32-bit words, Tw = Wn + 2W.  Host arrays:
// esym_prev [S, 2] int32, points [M, 2] float32, polys [symlen] uint32.
// Returns cudaGetLastError().
int cc_mc_longframe(int* out, unsigned* scratch, int lanes, int nsteps, int win0, int W,
                    int Wn, unsigned seed, float param, int soft, int snap, int K, int symlen,
                    const int* esym_prev, const float* points, const unsigned* polys,
                    unsigned qmask, float inv_nd, cudaStream_t stream) {
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  const int Tw = Wn + 2 * W;
  if (lanes <= 0 || nsteps < 0 || W < 0 || Wn <= 0 || S > CC_MAX_STATES ||
      M > CC_MAX_POINTS)
    return cudaErrorInvalidValue;
  LongframeParams p;
  const int bad = fill_seq_params(&p.s, seed, param, soft, snap, K, Tw, Tw + K - 1, symlen,
                                  points, polys, qmask, inv_nd);
  if (bad) return bad;
  fill_trellis(&p.tt, esym_prev, S);
  p.W = W;
  p.Wn = Wn;
  p.Tw = Tw;
  p.nsteps = nsteps;
  p.win0 = win0;
  p.lanes = lanes;
  const dim3 grid((lanes + kThreads - 1) / kThreads);
#define CC_LAUNCH_LONGFRAME(S_, M_) \
  mc_longframe_kernel<S_, M_><<<grid, kThreads, 0, stream>>>(out, scratch, p)
  CC_DISPATCH(S, M, CC_LAUNCH_LONGFRAME)
#undef CC_LAUNCH_LONGFRAME
  return (int)cudaGetLastError();
}

}  // extern "C"
