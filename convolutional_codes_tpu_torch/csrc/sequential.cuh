// Device code shared by the sequential kernels (stack_mc.cu, fano_mc.cu:
// the Monte-Carlo kernels and the decoders of supplied frames) and the
// frames entry (mc_datagen.cu): the coordinate hash, the encoder branch
// with the compat quirk, the per-frame datagen and the branch metric.
//
// The hash is the JAX package's coord_bits / coord_uniform
// (ops/fused_longframe.py:56-81) and the datagen its ops/mc_datagen.py
// (make_datagen :25): frame `gid` has info bits from salt 0 (tail zero),
// Box-Muller AWGN from salts 1 and 2 then the soft or snap-then-soft
// demapper, or BSC flips of coded bit k from salt 1 + k.  Everything is
// 32-bit unsigned math, so a frame depends only on (seed, gid) and never on
// the launch geometry.  Built with -fmad=false: every product is rounded
// before it is added, as the reference's float expressions are.
#pragma once

#include <cuda_runtime.h>

#define CC_SEQ_MAX_SYMLEN 4
#define CC_SEQ_MAX_POINTS (1 << CC_SEQ_MAX_SYMLEN)
#define CC_SEQ_THREADS 32

struct SeqParams {
  float px[CC_SEQ_MAX_POINTS], py[CC_SEQ_MAX_POINTS];  // constellation (AWGN)
  unsigned polys[CC_SEQ_MAX_SYMLEN];
  unsigned qmask;    // compat-parity quirk mask, 0 for true parity
  float inv_nd;      // 1 / ndist of the demapper
  float param;       // sigma (AWGN) or crossover probability (BSC)
  unsigned seed;
  int K, L, T, symlen, M;
  int soft;          // 1: AWGN distances [T][M]; 0: BSC received symbols [T]
  int snap;          // 1: snap-then-distance (hard) demapper
};

// Decoder constants on top of the datagen's.
struct SeqDecoderParams {
  SeqParams s;
  float weight;              // soft metric 1 + weight * dist
  int correct, wrong;        // hard metric per coded bit
  int timeout;               // Fano: SEARCH steps per frame
  int lanes, fpl;
};

// Returns 0, or cudaErrorInvalidValue for shapes the device code does not take.
static inline int fill_seq_params(SeqParams* p, unsigned seed, float param, int soft,
                                  int snap, int K, int L, int T, int symlen,
                                  const float* points, const unsigned* polys,
                                  unsigned qmask, float inv_nd) {
  if (K < 2 || K > 32 || L <= 0 || T != L + K - 1 || symlen < 1 ||
      symlen > CC_SEQ_MAX_SYMLEN)
    return (int)cudaErrorInvalidValue;
  const int M = 1 << symlen;
  for (int e = 0; e < CC_SEQ_MAX_POINTS; ++e) {
    p->px[e] = e < M ? points[2 * e] : 0.0f;
    p->py[e] = e < M ? points[2 * e + 1] : 0.0f;
  }
  for (int n = 0; n < CC_SEQ_MAX_SYMLEN; ++n) p->polys[n] = n < symlen ? polys[n] : 0u;
  p->qmask = qmask;
  p->inv_nd = inv_nd;
  p->param = param;
  p->seed = seed;
  p->K = K;
  p->L = L;
  p->T = T;
  p->symlen = symlen;
  p->M = M;
  p->soft = soft;
  p->snap = snap;
  return 0;
}

// Decoder constants for frames the caller supplies (no datagen, one frame
// per lane).  Returns 0, or cudaErrorInvalidValue.
static inline int fill_supplied_params(SeqDecoderParams* p, int soft, int K, int L, int T,
                                       int symlen, const unsigned* polys, unsigned qmask,
                                       float weight, int correct, int wrong, int timeout,
                                       int lanes) {
  static const float no_points[2 * CC_SEQ_MAX_POINTS] = {};
  const int bad = fill_seq_params(&p->s, 0u, 0.0f, soft, 0, K, L, T, symlen, no_points, polys,
                                  qmask, 0.0f);
  if (bad) return bad;
  if (lanes <= 0 || timeout < 0) return (int)cudaErrorInvalidValue;
  p->weight = weight;
  p->correct = correct;
  p->wrong = wrong;
  p->timeout = timeout;
  p->lanes = lanes;
  p->fpl = 1;
  return 0;
}

__device__ __forceinline__ unsigned seq_fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// coord_bits(lane, pos, seed, salt); saltc = salt * 0x68E31DA4 mod 2^32.
__device__ __forceinline__ unsigned coord_bits(unsigned gid, unsigned pos, unsigned seed,
                                               unsigned saltc) {
  unsigned c = (pos * 0x9E3779B9u) ^ (gid * 0x7FEB352Du);
  c = c + seed + saltc;
  return seq_fmix32(seq_fmix32(c) ^ gid);
}

__device__ __forceinline__ unsigned seq_salt(unsigned salt) { return salt * 0x68E31DA4u; }

// coord_uniform: 31 bits through int32 -> float32, in (0, 1).
__device__ __forceinline__ float coord_uniform(unsigned gid, unsigned pos, unsigned seed,
                                               unsigned saltc) {
  const int bits = (int)(coord_bits(gid, pos, seed, saltc) >> 1);
  return (float)bits * 4.656612873077392578125e-10f + 2.3283064365386962890625e-10f;
}

// Info bit t of frame gid (0 in the tail).
__device__ __forceinline__ unsigned frame_bit(const SeqParams& p, unsigned gid, int t) {
  return t < p.L ? (coord_bits(gid, (unsigned)t, p.seed, 0u) & 1u) : 0u;
}

// Expected symbol of a K-bit register, polynomial 0 at the MSB, with the
// compat quirk (models/trellis.py effective_parity_u64).
__device__ __forceinline__ unsigned seq_esym(unsigned reg, const SeqParams& p) {
  unsigned esym = 0;
  for (int n = 0; n < p.symlen; ++n) {
    const unsigned x = reg & p.polys[n];
    unsigned bit = __popc(x) & 1u;
    if (p.qmask) bit &= 1u - (__popc(x & p.qmask) & 1u);
    esym = (esym << 1) | bit;
  }
  return esym;
}

// Branch from a K-1-bit state with one input: r = state | input << (K-1),
// next state r >> 1; returns the expected symbol.
__device__ __forceinline__ unsigned seq_branch(unsigned state, unsigned input,
                                               const SeqParams& p, unsigned* next) {
  const unsigned r = state | (input << (p.K - 1));
  *next = r >> 1;
  return seq_esym(r, p);
}

// Channel output of symbol t of frame gid, whose expected symbol is esym:
// out(e, d) for the AWGN distance d of each point e (returns 0), or the
// BSC received symbol returned (out unused).
template <class Out>
__device__ __forceinline__ unsigned gen_symbol(const SeqParams& p, unsigned gid, int t,
                                               unsigned esym, Out out) {
  if (!p.soft) {
    unsigned fmask = 0;
    for (int k = 0; k < p.symlen; ++k)
      fmask |= (unsigned)(coord_uniform(gid, (unsigned)t, p.seed, seq_salt(1u + k)) <
                          p.param) << k;
    return esym ^ fmask;
  }
  const float u0 = coord_uniform(gid, (unsigned)t, p.seed, seq_salt(1u));
  const float u1 = coord_uniform(gid, (unsigned)t, p.seed, seq_salt(2u));
  const float r = sqrtf(-2.0f * logf(u0));
  const float theta = 6.28318530717958647692f * u1;
  float rxi = p.px[esym] + p.param * (r * cosf(theta));
  float rxq = p.py[esym] + p.param * (r * sinf(theta));
  if (p.snap) {  // nearest point by strict-less scan (first wins)
    float best = 0.0f;
    int be = 0;
    for (int e = 0; e < p.M; ++e) {
      const float di = rxi - p.px[e], dq = rxq - p.py[e];
      const float d = ((di * di) + (dq * dq)) * p.inv_nd;
      if (e == 0 || d < best) {
        best = d;
        be = e;
      }
    }
    rxi = p.px[be];
    rxq = p.py[be];
  }
  for (int e = 0; e < p.M; ++e) {
    const float di = rxi - p.px[e], dq = rxq - p.py[e];
    out(e, ((di * di) + (dq * dq)) * p.inv_nd);
  }
  return 0u;
}

// Write frame gid's channel output: AWGN distances at fs[(t*M + e)*stride]
// or BSC symbols at is[t*stride]; info bits (tail zero) at bits[t] when
// bits is not null.
__device__ inline void gen_frame(const SeqParams& p, unsigned gid, float* fs, int* is,
                                 size_t stride, int* bits) {
  unsigned reg = 0;
  for (int t = 0; t < p.T; ++t) {
    const unsigned bit = frame_bit(p, gid, t);
    if (bits) bits[t] = (int)bit;
    reg = (reg >> 1) | (bit << (p.K - 1));
    float* row = fs + (size_t)t * p.M * stride;
    const unsigned rx = gen_symbol(p, gid, t, seq_esym(reg, p),
                                   [&](int e, float d) { row[e * stride] = d; });
    if (!p.soft) is[(size_t)t * stride] = (int)rx;
  }
}

// Branch metric of expected symbol e at symbol t: soft 1 + fl(weight*d),
// hard hamming*wrong + (symlen-hamming)*correct (small integers, exact).
__device__ __forceinline__ float seq_metric(const SeqDecoderParams& p, const float* fs,
                                            const int* is, size_t stride, int t,
                                            unsigned e) {
  if (p.s.soft) return 1.0f + __fmul_rn(p.weight, fs[((size_t)t * p.s.M + e) * stride]);
  const int h = __popc(e ^ (unsigned)is[(size_t)t * stride]);
  return (float)(h * p.wrong + (p.s.symlen - h) * p.correct);
}
