// Device code shared by the sequential kernels (stack_mc.cu, fano_mc.cu:
// the Monte-Carlo kernels and the decoders of supplied frames) and the
// frames entry (mc_datagen.cu): the coordinate hash, the encoder branch
// with the compat quirk, the per-frame datagen, the branch metric, and
// the machinery of the persistent walks (slots, encoder, metric tables,
// the crew of a warp).
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

// The widest symbol the build takes: 4 coded bits (16 points) in the
// narrow libraries stack_mc and fano_mc, which every registered code uses;
// 8 (256 points, the widest code the JAX package takes) in their wide
// builds stack_mc_wide and fano_mc_wide (the same sources built with
// -DCC_SEQ_MAX_SYMLEN=8: utils/build.py) and in longframe_mc.cu and
// mc_datagen.cu, which define it before including this header.  The
// narrow libraries so compile exactly as before the wide codes came, and
// a wide build adds the device-memory constellation and the per-step
// metrics of its Monte-Carlo walks (CC_SEQ_WIDE: RowMetrics).
#ifndef CC_SEQ_MAX_SYMLEN
#define CC_SEQ_MAX_SYMLEN 4
#endif
#define CC_SEQ_MAX_POINTS (1 << CC_SEQ_MAX_SYMLEN)
#define CC_SEQ_NARROW_SYMLEN 4
#define CC_SEQ_WIDE (CC_SEQ_MAX_SYMLEN > CC_SEQ_NARROW_SYMLEN)
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
  unsigned gid0;             // Monte-Carlo: global id of the launch's frame 0
#if CC_SEQ_WIDE
  const float2* points;      // wide Monte-Carlo walks: the constellation in device memory
#endif
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
  p->gid0 = 0u;
#if CC_SEQ_WIDE
  p->points = nullptr;
#endif
  return 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A Monte-Carlo walk launch's clock while the host traces: two
// %globaltimer words, the first lane to leave on an empty queue (atomicMin;
// the host sets ~0) and the last lane's exit (atomicMax; 0).  Null
// otherwise.  A kernel argument of its own beside SeqDecoderParams (a field
// there moved kernel 7's registers from 71-72 to 92-96), read only at a
// lane's exit (a reading at the launch's start moved kernels 7 and 8's
// registers too: the host times the launch with events instead).
__device__ __forceinline__ void walk_clock_leave(unsigned long long* clock) {
  if (clock != nullptr) {
    const unsigned long long t = global_ns();
    atomicMin(clock, t);
    atomicMax(clock + 1, t);
  }
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

// The demapper's distance of the received point (rxi, rxq) to point (pxe,
// pye): gen_symbol's float operations, in its order.
__device__ __forceinline__ float point_dist(const SeqParams& p, float rxi, float rxq, float pxe,
                                            float pye) {
  const float di = rxi - pxe, dq = rxq - pye;
  return ((di * di) + (dq * dq)) * p.inv_nd;
}

#if CC_SEQ_WIDE
// gen_symbol's channel output before its distances: the BSC received
// symbol returned, or (AWGN, returns 0) the received point, snapped to the
// nearest point by the hard demapper, in rxi, rxq; point_dist from it to
// point e is gen_symbol's distance d(e) (the wide walks' RowMetrics).
__device__ __forceinline__ unsigned gen_received(const SeqParams& p, unsigned gid, int t,
                                                 unsigned esym, float& rxi, float& rxq) {
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
  rxi = p.px[esym] + p.param * (r * cosf(theta));
  rxq = p.py[esym] + p.param * (r * sinf(theta));
  if (p.snap) {  // nearest point by strict-less scan (first wins)
    float best = 0.0f;
    int be = 0;
    for (int e = 0; e < p.M; ++e) {
      const float d = point_dist(p, rxi, rxq, p.px[e], p.py[e]);
      if (e == 0 || d < best) {
        best = d;
        be = e;
      }
    }
    rxi = p.px[be];
    rxq = p.py[be];
  }
  return 0u;
}
#endif

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

// The persistent walks of the stack and Fano kernels: slots, the encoder
// in registers, branch metrics (a table per frame or computed from a
// supplied frame), and the crew that shares a warp's refills.

// The slot of lane `lane` of this thread's warp.
__device__ __forceinline__ unsigned slot_in_block(unsigned lane) {
  return (threadIdx.x & ~31u) + lane;
}

// The metric table of lane `lane`'s slot in a Monte-Carlo kernel (7, 8):
// T * M floats of device memory.
__device__ __forceinline__ float* slot_table(float* tables, int T, int M, unsigned lane) {
  return tables + ((size_t)blockIdx.x * blockDim.x + slot_in_block(lane)) * T * M;
}

// The encoder in registers: the polynomials in reverse order, zero beyond
// symlen, so that an expected symbol is one branch-free expression with
// constant shifts (seq_esym above, quirk included).
struct Encoder {
  unsigned rpoly[CC_SEQ_MAX_SYMLEN];   // rpoly[k] = polys[symlen - 1 - k]
  unsigned qmask, top;
  static __device__ __forceinline__ Encoder make(const SeqParams& p) {
    Encoder c;
#pragma unroll
    for (int k = 0; k < CC_SEQ_MAX_SYMLEN; ++k)
      c.rpoly[k] = k < p.symlen ? p.polys[p.symlen - 1 - k] : 0u;
    c.qmask = p.qmask;
    c.top = (unsigned)p.K - 1u;
    return c;
  }
  // Expected symbol of the branch from `state` with input `bit`.
  __device__ __forceinline__ unsigned esym(unsigned state, unsigned bit) const {
    const unsigned r = state | bit << top;
    unsigned e = 0u;
#pragma unroll
    for (int k = 0; k < CC_SEQ_MAX_SYMLEN; ++k) {
      const unsigned x = r & rpoly[k];
      e |= ((__popc(x) & ~__popc(x & qmask)) & 1u) << k;
    }
    return e;
  }
};

// A frame's branch metrics as a table, made once per frame: the metric of
// expected symbol e at node t at base[t * M + e].
struct TableMetrics {
  const float* base;
  unsigned M;
  __device__ __forceinline__ float at(int t, unsigned e) const {
    return base[(unsigned)t * M + e];
  }
};

// A supplied frame's branch metrics computed at each step from its symbols
// in device memory ([T][M] distances or [T] received symbols; seq_metric).
struct FrameMetrics {
  const SeqDecoderParams* p;
  const float* fs;
  __device__ __forceinline__ float at(int t, unsigned e) const {
    return seq_metric(*p, fs, (const int*)fs, 1, t, e);
  }
};

// Branch metrics of seq_metric, with the same float operations: soft from
// a distance d, hard from the received symbol rx and the expected symbol e.
__device__ __forceinline__ float soft_metric(const SeqDecoderParams& p, float d) {
  return 1.0f + __fmul_rn(p.weight, d);
}

__device__ __forceinline__ float hard_metric(const SeqDecoderParams& p, unsigned e, unsigned rx) {
  const int h = __popc(e ^ rx);
  return (float)(h * p.wrong + (p.s.symlen - h) * p.correct);
}

#if CC_SEQ_WIDE
// A wide Monte-Carlo frame's channel output in device memory, one row a
// symbol, made once per frame (crew_gen_wide): the received point (rxi,
// rxq), snapped by the hard demapper (AWGN), or the received symbol in
// the row's first word (BSC).  The metric of expected symbol e at node t
// is computed from it at each step with the table's float operations
// (point_dist to point e, then soft_metric; hard_metric): T * 2 words a
// slot where a table of 32-256 points would take T * M.
struct RowMetrics {
  const SeqDecoderParams* p;
  const float2* rows;
  __device__ __forceinline__ float at(int t, unsigned e) const {
    const float2 r = rows[t];
    if (!p->s.soft) return hard_metric(*p, e, __float_as_uint(r.x));
    const float2 q = p->points[e];
    return soft_metric(*p, point_dist(p->s, r.x, r.y, q.x, q.y));
  }
};
#endif

// Refills and retirements are collective over the lanes of a warp still
// in its loop (`alive`): a lane whose walk has stopped hands its frame to
// all of them, which share its writing out and the making of its next
// frame, so the work that is not a walk step runs on every lane instead
// of one lane at a time.  Rank r of the n alive lanes takes the part r of
// each such loop.
struct Crew {
  unsigned alive, lane;
  int rank, n;
  __device__ __forceinline__ void set(unsigned mask) {
    alive = mask;
    rank = __popc(alive & ((1u << lane) - 1u));
    n = __popc(alive);
  }
};

// Frame gid's metric table into the table `buf` of another lane, made by
// the crew: rank r makes symbols [r * seg, (r + 1) * seg) with gen_symbol,
// its encoder register primed with the K-1 info bits before them, and
// writes their metrics without reading the table back.
__device__ __forceinline__ void crew_gen(const SeqDecoderParams& p, const Crew& c, unsigned gid,
                                         float* buf) {
  const int T = p.s.T, K = p.s.K, M = p.s.M;
  const int seg = (T + c.n - 1) / c.n, t0 = c.rank * seg, t1 = min(T, t0 + seg);
  unsigned reg = 0u;
  for (int t = max(0, t0 - K + 1); t < t0; ++t)
    reg = (reg >> 1) | (frame_bit(p.s, gid, t) << (K - 1));
  for (int t = t0; t < t1; ++t) {
    reg = (reg >> 1) | (frame_bit(p.s, gid, t) << (K - 1));
    float* row = buf + (unsigned)t * M;
    const unsigned rx = gen_symbol(p.s, gid, t, seq_esym(reg, p.s), [&](int e, float d) {
      row[e] = soft_metric(p, d);
    });
    if (!p.s.soft)
      for (int e = 0; e < M; ++e) row[e] = hard_metric(p, (unsigned)e, rx);
  }
}

#if CC_SEQ_WIDE
// crew_gen for a wide walk: frame gid's rows of RowMetrics into `rows`,
// rank r of the crew making symbols [r * seg, (r + 1) * seg).
__device__ __forceinline__ void crew_gen_wide(const SeqDecoderParams& p, const Crew& c,
                                              unsigned gid, float2* rows) {
  const int T = p.s.T, K = p.s.K;
  const int seg = (T + c.n - 1) / c.n, t0 = c.rank * seg, t1 = min(T, t0 + seg);
  unsigned reg = 0u;
  for (int t = max(0, t0 - K + 1); t < t0; ++t)
    reg = (reg >> 1) | (frame_bit(p.s, gid, t) << (K - 1));
  for (int t = t0; t < t1; ++t) {
    reg = (reg >> 1) | (frame_bit(p.s, gid, t) << (K - 1));
    float rxi = 0.0f, rxq = 0.0f;
    const unsigned rx = gen_received(p.s, gid, t, seq_esym(reg, p.s), rxi, rxq);
    rows[t] = p.s.soft ? make_float2(rxi, rxq) : make_float2(__uint_as_float(rx), 0.0f);
  }
}
#endif
