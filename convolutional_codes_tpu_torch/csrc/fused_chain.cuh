// Fused Monte-Carlo Viterbi chain kernel for Hopper (sm_90a): the kernel
// body, shared by fused_chain.cu (the exact demapper and the BSC) and
// fused_chain_lin.cu (fast_demap), each of which instantiates its modes.
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
// block_lanes) and not on the CUDA block size.
//
// What bounds it on the H100: instruction issue.  Per trellis symbol a
// lane does two hashes (plus log/sqrt/sincos for AWGN, or symlen hashes
// for BSC), the encoder, the demapper, the ACS and its share of the
// traceback, all serially dependent along t, with no device memory
// traffic but the counters; chip_smoke.py counts the instructions of the
// code-0 instance's loops in its SASS.  So the design removes
// instructions, each change exact by construction: the channel is a
// template parameter (no branch per symbol); each transition reads its
// branch metric from the lane's column of shared memory (acs.cuh's
// acs_step_smem, shared with kernel 6) where a pick from registers took
// M-1 compares and selects; the expected symbol comes from a 64-bit table
// of every register where 2^K symlen <= 64 (code 0: 16 bits); a BSC flip
// compares the draw's integer with a threshold computed on the host; one
// sincosf replaces sinf and cosf (the same bits: chip_smoke checks 2^24 of
// the chain's angles); the decisions of S < 32 states pack 32/S rows a word
// in the per-thread local array (code 0: 6 words an MC step where there
// were 42), and the traceback walks them a word at a time, its rows
// unrolled; the info bits the forward pass draws are stored 32 a word, and
// the traceback counts errors a 32-row word at a time by popcount instead
// of drawing each bit again.
//
// The fast_demap variant (the JAX package's opt-in `dist_vec_lin`,
// fused_chain.py:207-249) is two more modes, kSoftLin and kSnapLin: the
// distance to point e becomes (rxi ci[e] + rxq cq[e]) + pe2[e], the terms
// common to every e dropped (ops/fused_chain.lin_params derives ci, cq and
// pe2 on the host; pe2 is left out for a constant-modulus constellation),
// in the soft metrics and, in snap mode, both times.  Modes and not a
// runtime flag: as a flag of the soft and snap instances it spilled two of
// them (S = 4, M = 2 soft; S = 8, M = 4 snap) and slowed the exact
// demapper by 3% (PERF.md); as modes the exact instances keep the code
// they had without the variant.  Their 48 instances are a library of their
// own (fused_chain_lin.cu), built beside the exact one's 72, so that the
// opt-in variant does not lengthen the build.
//
// Exactness: built with -fmad=false, so rxi = txi + param*noise and
// ((di*di)+(dq*dq))*inv_nd round every product as the reference's float
// expressions do; compares are strict-less.  BSC runs carry no
// transcendental and match the reference bit for bit; AWGN goes through
// logf/sqrtf/sincosf, whose last-ulp results differ from XLA's.
#pragma once

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
  // BSC: coded bit k flips where hash_uniform(..) < param, which is
  // (hash_bits(..) >> 1) < flip_below (the uniform is monotone in the bits)
  unsigned flip_below;
  // the expected symbol of every K-bit register where 2^K symlen <= 64
  unsigned long long esym_tab;
  unsigned seed;
  int K, L, T, nsteps, Bt, B;
  // fast_demap's linear form (after the fields above, which keep their
  // offsets); pe2 is added where pe2_on (a constellation of several moduli)
  float ci[CC_MAX_POINTS], cq[CC_MAX_POINTS], pe2[CC_MAX_POINTS];
  int pe2_on;
};

// The channel and demapper of an instance: BSC with Hamming metrics and
// 0xFF00 saturation, AWGN soft, AWGN snap-then-distance (hard demapper),
// and the last two with fast_demap's linear distances.
enum Mode { kBsc = 0, kSoft = 1, kSnap = 2, kSoftLin = 3, kSnapLin = 4 };

// Decision layout for S states: S < 32 packs P = 32/S rows per word (row t
// in bits (t mod P) S .. of word t / P), else NW words a row.
template <int S>
struct Pack {
  static constexpr int NW = (S + 31) / 32;
  static constexpr int P = S < 32 ? 32 / S : 1;
  static constexpr int WORDS = (kMaxSymbols + P - 1) / P * NW;
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

constexpr float kTwoPi = 6.28318530717958647692f;

template <int M>
__host__ __device__ constexpr int symlen_of() {
  return M == 2 ? 1 : (M == 4 ? 2 : 3);
}

// Whether the expected symbols of all 2^K = 2 S registers fit in 64 bits.
template <int S, int M>
__host__ __device__ constexpr bool esym_packed() {
  return 2 * S * symlen_of<M>() <= 64;
}

// Encoder parity per polynomial, polynomial 0 at the symbol MSB, with the
// compat quirk (models/trellis.py effective_parity_u64): from the packed
// table where the code is small enough, else by popcount.
template <int S, int M>
__device__ __forceinline__ unsigned esym_of(unsigned reg, const ChainParams& p) {
  constexpr int SL = symlen_of<M>();
  if constexpr (esym_packed<S, M>())
    return (unsigned)(p.esym_tab >> (reg * SL)) & (unsigned)(M - 1);
  unsigned esym = 0;
#pragma unroll
  for (int n = 0; n < SL; ++n) {
    const unsigned x = reg & p.polys[n];
    unsigned bit = __popc(x) & 1u;
    if (p.qmask) bit &= 1u - (__popc(x & p.qmask) & 1u);
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

// The linear-form distances of fast_demap (ops/fused_chain._dist_vec_lin,
// whose values these equal: negation is exact, and its signed sums are
// these sums reordered).
template <int M>
__device__ __forceinline__ void dist_vec_lin(float rxi, float rxq, const ChainParams& p,
                                             float (&bm)[M]) {
#pragma unroll
  for (int e = 0; e < M; ++e) {
    bm[e] = rxi * p.ci[e] + rxq * p.cq[e];
    if (p.pe2_on) bm[e] = bm[e] + p.pe2[e];
  }
}

template <int M, bool LIN>
__device__ __forceinline__ void demap(float rxi, float rxq, const ChainParams& p,
                                      float (&bm)[M]) {
  if constexpr (LIN)
    dist_vec_lin<M>(rxi, rxq, p, bm);
  else
    dist_vec<M>(rxi, rxq, p, bm);
}

// Branch metrics of trellis step t for one lane into its column of shared
// memory, bmcol[e kThreads]; advances the encoder and returns the info bit.
template <int S, int M, int MODE>
__device__ __forceinline__ unsigned branch_metrics(const ChainParams& p, int t, unsigned j,
                                                   unsigned sbase, unsigned& reg,
                                                   float* bmcol) {
  const unsigned plane = (unsigned)p.T * (unsigned)p.Bt;
  const unsigned idx = (unsigned)t * (unsigned)p.Bt + j;
  const unsigned bit = t < p.L ? (hash_bits(idx, sbase, kSalt0) & 1u) : 0u;
  reg = (reg >> 1) | (bit << (p.K - 1));
  const unsigned esym = esym_of<S, M>(reg, p);
  float bm[M];
  if constexpr (MODE == kBsc) {
    unsigned fmask = 0;
#pragma unroll
    for (int k = 0; k < symlen_of<M>(); ++k)
      fmask |= (unsigned)((hash_bits((unsigned)k * plane + idx, sbase, kSalt1) >> 1) <
                          p.flip_below) << k;
    const unsigned rx = esym ^ fmask;
#pragma unroll
    for (int e = 0; e < M; ++e) bm[e] = (float)__popc(rx ^ (unsigned)e);
  } else {
    const float u0 = hash_uniform(idx, sbase, kSalt2);
    const float u1 = hash_uniform(plane + idx, sbase, kSalt2);
    const float r = sqrtf(-2.0f * logf(u0));
    float s, c;
    sincosf(kTwoPi * u1, &s, &c);   // the bits of sinf and cosf (chip_smoke checks)
    const float rxi = p.px[esym] + p.param * (r * c);
    const float rxq = p.py[esym] + p.param * (r * s);
    constexpr bool LIN = MODE == kSoftLin || MODE == kSnapLin;
    demap<M, LIN>(rxi, rxq, p, bm);
    if constexpr (MODE == kSnap || MODE == kSnapLin) {
      float best = bm[0], sxi = p.px[0], sxq = p.py[0];
#pragma unroll
      for (int e = 1; e < M; ++e) {
        if (bm[e] < best) {
          best = bm[e];
          sxi = p.px[e];
          sxq = p.py[e];
        }
      }
      demap<M, LIN>(sxi, sxq, p, bm);
    }
  }
#pragma unroll
  for (int e = 0; e < M; ++e) bmcol[e * kThreads] = bm[e];
  return bit;
}

// Trellis step t of one lane, src -> dst: the branch metrics, one ACS step,
// the decisions into dec (S < 32: packed into acc, the word stored with its
// last row) and the info bit into info (a word stored with its last row).
template <int S, int M, int MODE>
__device__ __forceinline__ void chain_time_step(const ChainParams& p, int t, unsigned j,
                                                unsigned sbase, unsigned& reg,
                                                const float (&src)[S], float (&dst)[S],
                                                float* bmcol, unsigned* dec, unsigned& acc,
                                                unsigned* info, unsigned& iacc) {
  using Pk = Pack<S>;
  const unsigned bit = branch_metrics<S, M, MODE>(p, t, j, sbase, reg, bmcol);
  unsigned words[Pk::NW];
  acs_step_smem<S, kThreads>(src, dst, bmcol, MODE == kBsc, p.tt, words);
  if constexpr (Pk::P > 1) {
    const int i = t & (Pk::P - 1);
    acc |= words[0] << (i * S);
    if (i == Pk::P - 1 || t == p.T - 1) {
      dec[t / Pk::P] = acc;
      acc = 0;
    }
  } else {
#pragma unroll
    for (int w = 0; w < Pk::NW; ++w) dec[t * Pk::NW + w] = words[w];
  }
  iacc |= bit << (t & 31);
  if ((t & 31) == 31 || t == p.T - 1) {
    info[t >> 5] = iacc;
    iacc = 0;
  }
}

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }

// The P = 32/S rows of a traceback (S < 32) in one packed word, top row
// first: the decoded bit of each row (the state's top bit) shifted into
// dacc (a 32-row word walked from its top row down ends with row t in bit
// t mod 32), cur back to the state before the item's first row.
template <int S>
__device__ __forceinline__ void walk_item(unsigned word, unsigned& cur, unsigned& dacc) {
#pragma unroll
  for (int i = Pack<S>::P - 1; i >= 0; --i) {
    const unsigned survivor = (word >> (i * S + (int)cur)) & 1u;
    dacc = (dacc << 1) | (cur >> (log2i(S) - 1));
    cur = ((cur & (unsigned)(S / 2 - 1)) << 1) | survivor;
  }
}

// Once the rows of a 32-row word down to row t are walked (t mod 32 = 0):
// the errors of its rows below L, decoded bits against stored info bits.
__device__ __forceinline__ void count_errors(int t, int L, const unsigned* info,
                                             unsigned& dacc, int& err) {
  if ((t & 31) == 0) {
    const int rows = L - t;   // rows t .. t+31 below L
    const unsigned mask = rows >= 32 ? ~0u : (rows > 0 ? (1u << rows) - 1u : 0u);
    err += __popc((dacc ^ info[t >> 5]) & mask);
    dacc = 0;
  }
}

template <int S, int M, int MODE>
__global__ void __launch_bounds__(kThreads)
mc_chain_kernel(int* __restrict__ out, const __grid_constant__ ChainParams p) {
  using Pk = Pack<S>;
  __shared__ float bm_s[M * kThreads];   // [e][thread]: the row's branch metrics
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.B) return;
  float* bmcol = bm_s + threadIdx.x;
  const unsigned tile = (unsigned)g / (unsigned)p.Bt;
  const unsigned j = (unsigned)g % (unsigned)p.Bt;
  const unsigned hbase = lowbias32((p.seed * 0x9E3779B9u) ^ ((tile + 1u) * 0xC2B2AE35u));
  const float init = MODE == kBsc ? CC_HARD_SAT : 1e30f;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  unsigned dec[Pk::WORDS];
  unsigned info[kMaxSymbols / 32];
  int errs = 0, ferrs = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    const unsigned sbase = hbase + (unsigned)step * 0x85EBCA6Bu;
    float ma[S], mb[S];
    ma[0] = 0.0f;
#pragma unroll
    for (int s = 1; s < S; ++s) ma[s] = init;
    unsigned reg = 0, acc = 0, iacc = 0;
    int t = 0;
#pragma unroll 1
    for (; t + 1 < p.T; t += 2) {
      chain_time_step<S, M, MODE>(p, t, j, sbase, reg, ma, mb, bmcol, dec, acc, info, iacc);
      chain_time_step<S, M, MODE>(p, t + 1, j, sbase, reg, mb, ma, bmcol, dec, acc, info,
                                  iacc);
    }
    unsigned cur;
    if (t < p.T) {
      chain_time_step<S, M, MODE>(p, t, j, sbase, reg, ma, mb, bmcol, dec, acc, info, iacc);
      cur = argmin_state<S>(mb);
    } else {
      cur = argmin_state<S>(ma);
    }
    // the traceback: the decoded bits of each 32-row word (shifted in from
    // its top row down) against the stored info bits of its rows t < L, by
    // popcount
    int err = 0;
    unsigned dacc = 0;
    if constexpr (Pk::P > 1) {
      // the top item's rows (T may end inside it) one at a time, then a
      // packed word at a time with its rows unrolled
      int item = (p.T - 1) / Pk::P;
      const unsigned top = dec[item];
#pragma unroll 1
      for (t = p.T - 1; t >= item * Pk::P; --t) {
        const unsigned survivor = (top >> ((t - item * Pk::P) * S + (int)cur)) & 1u;
        dacc = (dacc << 1) | (cur >> (log2i(S) - 1));
        cur = ((cur & half_mask) << 1) | survivor;
      }
      count_errors(item * Pk::P, p.L, info, dacc, err);
#pragma unroll 1
      for (--item; item >= 0; --item) {
        walk_item<S>(dec[item], cur, dacc);
        count_errors(item * Pk::P, p.L, info, dacc, err);
      }
    } else {
#pragma unroll 1
      for (t = p.T - 1; t >= 0; --t) {
        const unsigned word = dec[t * Pk::NW + (int)(cur >> 5)];
        dacc = (dacc << 1) | (cur >> (log2i(S) - 1));
        count_errors(t, p.L, info, dacc, err);
        cur = ((cur & half_mask) << 1) | ((word >> (cur & 31u)) & 1u);
      }
    }
    errs += err;
    ferrs += err > 0;
  }
  out[g] = errs;
  out[(size_t)p.B + g] = ferrs;
}

// The parameter block of one launch; false where the shape is outside the
// kernel's limits.  ci, cq, pe2: fast_demap's linear form, or null.
inline bool init_chain_params(ChainParams& p, int B, int Bt, int nsteps, unsigned seed,
                              float param, unsigned flip_below, int K, int L, int T,
                              int symlen, const int* esym_prev, const float* points,
                              const unsigned* polys, unsigned qmask, float inv_nd,
                              const float* ci, const float* cq, const float* pe2) {
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  if (B <= 0 || Bt <= 0 || B % Bt || nsteps < 0 || T > kMaxSymbols || L > T ||
      symlen > 3 || S > CC_MAX_STATES || K < 2)
    return false;
  fill_trellis(&p.tt, esym_prev, S);
  for (int e = 0; e < CC_MAX_POINTS; ++e) {
    p.px[e] = e < M ? points[2 * e] : 0.0f;
    p.py[e] = e < M ? points[2 * e + 1] : 0.0f;
  }
  for (int n = 0; n < 8; ++n) p.polys[n] = n < symlen ? polys[n] : 0u;
  p.qmask = qmask;
  p.inv_nd = inv_nd;
  p.pe2_on = 0;
  for (int e = 0; e < CC_MAX_POINTS; ++e) {
    p.ci[e] = ci && e < M ? ci[e] : 0.0f;
    p.cq[e] = cq && e < M ? cq[e] : 0.0f;
    p.pe2[e] = pe2 && e < M ? pe2[e] : 0.0f;
    p.pe2_on |= p.pe2[e] != 0.0f;
  }
  p.param = param;
  p.flip_below = flip_below;
  int packed;
  p.esym_tab = pack_esym_table(K, symlen, polys, qmask, &packed);
  p.seed = seed;
  p.K = K;
  p.L = L;
  p.T = T;
  p.nsteps = nsteps;
  p.Bt = Bt;
  p.B = B;
  return true;
}

}  // namespace
