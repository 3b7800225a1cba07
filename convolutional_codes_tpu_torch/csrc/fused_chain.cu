// Fused Monte-Carlo Viterbi chain kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel convolutional_codes_tpu/ops/fused_chain.py
// `_mc_kernel` (:400, entry mc_chain_viterbi :641; loop schedule only).
// Each thread runs nsteps whole Monte-Carlo steps of one lane: counter-hash
// info bits (tail rows zero) -> shift-register encode with the compat
// quirk -> QPSK/8-QAM map + Box-Muller AWGN, or per-coded-bit BSC flips ->
// soft, snap-then-distance or Hamming branch metrics -> ACS -> argmin ->
// traceback -> bit and frame error counts.  Only the [2, B] int32 counters
// reach device memory.
//
// RNG: the reference package's interpret-mode counter hash (_lowbias32,
// _interp_bits, _interp_uniform :76-102, _hbase_for :384, _step_base :394,
// salts 0/1/2).  A lane g belongs to logical tile g / Bt at in-tile index
// j = g % Bt; the flat hash index of plane element (k, t, j) is
// k*T*Bt + t*Bt + j, so the stream depends on Bt (the reference's
// block_lanes) and not on the CUDA block size.  The info bits are
// regenerated from the hash in the traceback instead of being stored.
//
// What bounds it on the H100: per trellis step a lane does two hashes (plus
// log/sqrt/sin/cos for AWGN, or symlen hashes for BSC), the demapper, and
// about 8 S ACS operations, all serially dependent along t; no device
// memory traffic except the decisions, which live in per-thread local
// memory (T * ceil(S/32) words: 42 for code 0, 864 for K=9) and so go
// through L1/L2.  So it is bound by instruction issue, not by device
// memory: the design keeps everything of a lane in registers or local
// memory and launches one thread per lane, B in all.
//
// Exactness: built with -fmad=false, so rxi = txi + param*noise and
// ((di*di)+(dq*dq))*inv_nd round every product as the reference's float
// expressions do; compares are strict-less.  BSC runs carry no
// transcendental and match the reference bit for bit; AWGN goes through
// logf/sqrtf/sinf/cosf, whose last-ulp results differ from XLA's.
#include "acs.cuh"

namespace {

constexpr int kThreads = 128;
// The per-thread decision array holds kMaxSymbols trellis steps.
constexpr int kMaxSymbols = 256;

struct ChainParams {
  TrellisTables tt;
  float px[CC_MAX_POINTS], py[CC_MAX_POINTS];
  unsigned polys[8];
  unsigned qmask;
  float inv_nd;
  float param;   // sigma (awgn) or crossover probability (bsc)
  unsigned seed;
  int K, L, T, symlen, nsteps, Bt, B;
  int bsc;       // 1: BSC + Hamming metrics with 0xFF00 saturation
  int snap;      // 1: snap-then-distance (hard) demapper on AWGN
};

__device__ __forceinline__ unsigned lowbias32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// _interp_bits for one flat index; saltc = (salt * 0x85EBCA6B) mod 2^32.
__device__ __forceinline__ unsigned hash_bits(unsigned idx, unsigned sbase, unsigned saltc) {
  return lowbias32(lowbias32(idx * 0x9E3779B9u + sbase) ^ saltc);
}

// _interp_uniform: 31 bits through int32 -> float32, in (0, 1).
__device__ __forceinline__ float hash_uniform(unsigned idx, unsigned sbase, unsigned saltc) {
  const int bits = (int)(hash_bits(idx, sbase, saltc) >> 1);
  return (float)bits * 4.656612873077392578125e-10f + 2.3283064365386962890625e-10f;
}

constexpr unsigned kSalt0 = 0u;
constexpr unsigned kSalt1 = 0x85EBCA6Bu;
constexpr unsigned kSalt2 = 0x0BD794D6u;  // 2 * 0x85EBCA6B mod 2^32

__device__ __forceinline__ unsigned parity32(unsigned x) { return __popc(x) & 1u; }

// Encoder parity per polynomial, polynomial 0 at the symbol MSB, with the
// compat quirk (models/trellis.py effective_parity_u64).
__device__ __forceinline__ unsigned esym_of(unsigned reg, const ChainParams& p) {
  unsigned esym = 0;
  for (int n = 0; n < p.symlen; ++n) {
    const unsigned x = reg & p.polys[n];
    unsigned bit = parity32(x);
    if (p.qmask) bit &= 1u - parity32(x & p.qmask);
    esym = (esym << 1) | bit;
  }
  return esym;
}

template <int M>
__device__ __forceinline__ void dist_vec(float rxi, float rxq, const ChainParams& p,
                                         float (&bm)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const float di = rxi - p.px[e];
    const float dq = rxq - p.py[e];
    bm[e] = ((di * di) + (dq * dq)) * p.inv_nd;
  }
}

// Branch metrics of trellis step t for one lane; advances the encoder.
template <int M>
__device__ __forceinline__ void branch_metrics(const ChainParams& p, int t, unsigned j,
                                               unsigned sbase, unsigned& reg,
                                               float (&bm)[M]) {
  const unsigned plane = (unsigned)p.T * (unsigned)p.Bt;
  const unsigned idx = (unsigned)t * (unsigned)p.Bt + j;
  const unsigned bit = t < p.L ? (hash_bits(idx, sbase, kSalt0) & 1u) : 0u;
  reg = (reg >> 1) | (bit << (p.K - 1));
  const unsigned esym = esym_of(reg, p);
  if (p.bsc) {
    unsigned fmask = 0;
    for (int k = 0; k < p.symlen; ++k) {
      const float u = hash_uniform((unsigned)k * plane + idx, sbase, kSalt1);
      fmask |= (unsigned)(u < p.param) << k;
    }
    const unsigned rx = esym ^ fmask;
#pragma unroll
    for (int e = 0; e < M; ++e) bm[e] = (float)__popc(rx ^ (unsigned)e);
    return;
  }
  const float u0 = hash_uniform(idx, sbase, kSalt2);
  const float u1 = hash_uniform(plane + idx, sbase, kSalt2);
  const float r = sqrtf(-2.0f * logf(u0));
  const float theta = 6.28318530717958647692f * u1;
  const float rxi = p.px[esym] + p.param * (r * cosf(theta));
  const float rxq = p.py[esym] + p.param * (r * sinf(theta));
  dist_vec<M>(rxi, rxq, p, bm);
  if (p.snap) {
    float best = bm[0], sxi = p.px[0], sxq = p.py[0];
#pragma unroll
    for (int e = 1; e < M; ++e) {
      if (bm[e] < best) {
        best = bm[e];
        sxi = p.px[e];
        sxq = p.py[e];
      }
    }
    dist_vec<M>(sxi, sxq, p, bm);
  }
}

template <int S, int M>
__device__ __forceinline__ void chain_time_step(const ChainParams& p, int t, unsigned j,
                                                unsigned sbase, unsigned& reg,
                                                const float (&src)[S], float (&dst)[S],
                                                unsigned* dec) {
  constexpr int NW = (S + 31) / 32;
  float bm[M];
  unsigned words[NW];
  branch_metrics<M>(p, t, j, sbase, reg, bm);
  acs_step<S, M>(src, dst, bm, p.bsc != 0, p.tt, words);
#pragma unroll
  for (int w = 0; w < NW; ++w) dec[t * NW + w] = words[w];
}

template <int S, int M>
__global__ void __launch_bounds__(kThreads)
mc_chain_kernel(int* __restrict__ out, const __grid_constant__ ChainParams p) {
  constexpr int NW = (S + 31) / 32;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.B) return;
  const unsigned tile = (unsigned)g / (unsigned)p.Bt;
  const unsigned j = (unsigned)g % (unsigned)p.Bt;
  const unsigned hbase = lowbias32((p.seed * 0x9E3779B9u) ^ ((tile + 1u) * 0xC2B2AE35u));
  const float init = p.bsc ? CC_HARD_SAT : 1e30f;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  unsigned dec[kMaxSymbols * NW];
  int errs = 0, ferrs = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    const unsigned sbase = hbase + (unsigned)step * 0x85EBCA6Bu;
    float ma[S], mb[S];
    ma[0] = 0.0f;
#pragma unroll
    for (int s = 1; s < S; ++s) ma[s] = init;
    unsigned reg = 0;
    int t = 0;
    for (; t + 1 < p.T; t += 2) {
      chain_time_step<S, M>(p, t, j, sbase, reg, ma, mb, dec);
      chain_time_step<S, M>(p, t + 1, j, sbase, reg, mb, ma, dec);
    }
    unsigned cur;
    if (t < p.T) {
      chain_time_step<S, M>(p, t, j, sbase, reg, ma, mb, dec);
      cur = argmin_state<S>(mb);
    } else {
      cur = argmin_state<S>(ma);
    }
    int err = 0, fe = 0;
    for (t = p.T - 1; t >= 0; --t) {
      const unsigned word = dec[t * NW + (cur >> 5)];
      const unsigned survivor = (word >> (cur & 31u)) & 1u;
      if (t < p.L) {
        const unsigned sent =
            hash_bits((unsigned)t * (unsigned)p.Bt + j, sbase, kSalt0) & 1u;
        const int mism = (cur >> (p.K - 2)) != sent;
        err += mism;
        fe |= mism;
      }
      cur = ((cur & half_mask) << 1) | survivor;
    }
    errs += err;
    ferrs += fe;
  }
  out[g] = errs;
  out[(size_t)p.B + g] = ferrs;
}

}  // namespace

extern "C" {

// out [2, B] int32 (bit errors, frame errors per lane).  Host arrays:
// esym_prev [S, 2] int32, points [M, 2] float32, polys [symlen] uint32.
// Returns cudaGetLastError().
int cc_mc_chain(int* out, int B, int Bt, int nsteps, unsigned seed, float param,
                int bsc, int snap, int K, int L, int T, int symlen,
                const int* esym_prev, const float* points, const unsigned* polys,
                unsigned qmask, float inv_nd, cudaStream_t stream) {
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  if (B <= 0 || Bt <= 0 || B % Bt || nsteps < 0 || T > kMaxSymbols || L > T ||
      symlen > 3 || S > CC_MAX_STATES)
    return cudaErrorInvalidValue;
  ChainParams p;
  fill_trellis(&p.tt, esym_prev, S);
  for (int e = 0; e < CC_MAX_POINTS; ++e) {
    p.px[e] = e < M ? points[2 * e] : 0.0f;
    p.py[e] = e < M ? points[2 * e + 1] : 0.0f;
  }
  for (int n = 0; n < 8; ++n) p.polys[n] = n < symlen ? polys[n] : 0u;
  p.qmask = qmask;
  p.inv_nd = inv_nd;
  p.param = param;
  p.seed = seed;
  p.K = K;
  p.L = L;
  p.T = T;
  p.symlen = symlen;
  p.nsteps = nsteps;
  p.Bt = Bt;
  p.B = B;
  p.bsc = bsc;
  p.snap = snap;
  const dim3 grid((B + kThreads - 1) / kThreads);
#define CC_LAUNCH_CHAIN(S_, M_) mc_chain_kernel<S_, M_><<<grid, kThreads, 0, stream>>>(out, p)
  CC_DISPATCH(S, M, CC_LAUNCH_CHAIN)
#undef CC_LAUNCH_CHAIN
  return (int)cudaGetLastError();
}

}  // extern "C"
