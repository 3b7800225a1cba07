// Fused long-frame Monte-Carlo Viterbi kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel convolutional_codes_tpu/ops/fused_longframe.py
// `_mc_longframe_kernel` (:84, entry mc_longframe_viterbi :223).  Each
// lane decodes an unterminated coded stream in nsteps overlap-save windows
// of Tw = Wn + 2W symbols (W-symbol halos on both sides of a Wn-symbol
// payload).  Window `win0 + step` covers the stream positions from
// (win0 + step) * Wn - W on, and the K-1 info bits before them seed the
// encoder register, so the halos replay the same bits and noise as the
// neighbouring windows.  Per symbol: the info bit from hash salt 0, the
// encoder with the compat quirk, then BSC flips of coded bit k from salt
// 1 + k, or Box-Muller AWGN from salts 1 and 2 and the soft (or
// snap-then-soft) demapper; then one ACS step from zero start metrics.
// After Tw steps: the first state of least metric, and the traceback from
// row Tw-1 down to row W, counting errors on the payload rows only.  The
// hash is sequential.cuh's coord_bits keyed by the global lane, so the
// counters depend neither on the block size nor on the thread group.
// Only the [2, lanes] counters (bit errors, windows with an error) are
// results.
//
// What bounds it on the H100: instruction issue.  Per symbol a lane does
// three hashes (BSC; AWGN adds log/sqrt/sin/cos), the encoder, the
// demapper and about 20 instructions per state of ACS, all dependent along
// t; config 0 (k3-75 BSC) issues ~230 instructions per lane and symbol
// (counted from the source), about one per cycle on each SM quarter.  So
// the design cuts instructions: a BSC flip compares the draw's integer with a threshold
// computed on the host (no int-to-float conversion, exactly the plain
// compare), the expected symbol comes from a 64-bit table of every
// register where the code is small (k3-75: 8 registers of 2 bits), the
// loops over the symbol's bits unroll, and the traceback counts errors a
// 32-bit word at a time against info bits that the forward pass, which
// draws them anyway, stores (1.5% faster than drawing them again at
// config 0, PERF.md).  The survivor decisions go to a device scratch that the
// traceback reads back, [items, words, lanes] so that a warp's stores and
// loads are coalesced; only the rows the traceback reads are stored
// (t >= W), and for S < 32 the S decision bits of P = 32 / S rows share
// one word (k3-75: 8 rows), aligned to multiples of P.  The traceback is a
// short loop of one row an iteration: the windows' lanes are resident at
// once and hide its loads, and walks unrolled to load a group of rows
// ahead were slower at config 0 (PERF.md).
//
// The branch metrics of a row go through shared memory: each transition
// reads its metric at a computed address, one load where a pick from
// registers took M-1 compares and selects, and the registers the picks
// held are free (nasa-k7: 164 registers, 12 warps per SM; 255 before).
// S >= 128 holds too many metrics for one thread (2 S floats spill), so a
// group of G threads shares a lane there, thread r holding states
// [r S/G, (r+1) S/G): the butterfly's two predecessors of thread r's
// states are all held by threads 2 (r mod G/2) and that + 1, whose metrics
// arrive by warp shuffle; the group draws G symbols at once (thread r the
// symbol of row t0 + r) into shared memory; the argmin reduces across the
// group by strict-less value, then lower state, which is the first-state
// rule.  G = S / 32 (32 states a thread): 1.5x (S = 128) and 3.6x
// (S = 256) faster than one thread a lane, while groups of 2-8 at S = 64
// were slower (PERF.md).  Every state's ACS is the same float32
// expression either way.
//
// Codes of 16-256 points (rate 1/4 to 1/8) run one instance per S with M
// at run time: a row keeps its received symbol or point, and each
// transition computes its branch metric where the ACS reads it
// (received_row, acs.cuh's acs_step_fn), since a column of M metrics a
// thread would not fit in shared memory.
//
// Exactness: built with -fmad=false, strict-less compares, the same
// float32 expressions as the plain version; BSC runs carry no
// transcendental and match it bit for bit.
#include "acs.cuh"
#define CC_SEQ_MAX_SYMLEN 8   // every width the JAX package takes (up to 256 points)
#include "sequential.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct LongframeParams {
  TrellisTables tt;
  SeqParams s;    // seed, channel, constellation, encoder; L = Tw, T = Tw + K - 1
  int W, Wn, Tw, nsteps, win0, lanes;
  // BSC: coded bit k flips where coord_uniform(..) < param, which is
  // (coord_bits(..) >> 1) < flip_below (the uniform is monotone in the bits)
  unsigned flip_below;
  // the expected symbol of every K-bit register, symlen bits each, where
  // 2^K symlen <= 64 (esym_packed)
  unsigned long long esym_tab;
  int esym_packed;
};

// Decision scratch layout for S states: items of P rows (S < 32 packs
// P = 32/S rows per word), NW words each.
template <int S>
struct Pack {
  static constexpr int NW = (S + 31) / 32;
  static constexpr int P = S < 32 ? 32 / S : 1;
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

// Expected symbol of the K-bit register reg (sequential.cuh's seq_esym with
// symlen = log2 M known at compile time), from the packed table where the
// code is small enough.
template <int M>
__device__ __forceinline__ unsigned esym_of(const LongframeParams& p, unsigned reg) {
  constexpr int SL = M == 2 ? 1 : (M == 4 ? 2 : 3);
  if (p.esym_packed) return (unsigned)(p.esym_tab >> (reg * SL)) & (unsigned)(M - 1);
  unsigned esym = 0;
#pragma unroll
  for (int n = 0; n < SL; ++n) {
    const unsigned x = reg & p.s.polys[n];
    unsigned bit = __popc(x) & 1u;
    if (p.s.qmask) bit &= 1u - (__popc(x & p.s.qmask) & 1u);
    esym = (esym << 1) | bit;
  }
  return esym;
}

// Branch metrics of the symbol at stream position pos, expected symbol esym.
template <int M>
__device__ __forceinline__ void branch_metrics(const LongframeParams& lp, unsigned lane,
                                               unsigned pos, unsigned esym, float (&bm)[M]) {
  const SeqParams& p = lp.s;
  if (!p.soft) {
    constexpr int SL = M == 2 ? 1 : (M == 4 ? 2 : 3);
    unsigned fmask = 0;
#pragma unroll
    for (int k = 0; k < SL; ++k)
      fmask |= (unsigned)((coord_bits(lane, pos, p.seed, seq_salt(1u + k)) >> 1) <
                          lp.flip_below) << k;
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

// Codes of M = 16-256 points (M at run time, the instances <S, 0>): a
// thread's column of M metrics would take 8-128 KB of shared memory a
// block, so a row keeps only its received symbol (BSC) or received point
// (AWGN, snapped by the hard demapper), and each transition computes its
// branch metric where the ACS reads it, with branch_metrics' float
// operations in the same order: the Hamming distance, or the distance to
// point esym.  Returns the BSC received symbol (flips as branch_metrics
// draws them), or 0 with the point in rxi, rxq (sequential.cuh's
// gen_received, the same Box-Muller and snap).
__device__ __forceinline__ unsigned received_row(const LongframeParams& lp, unsigned lane,
                                                 unsigned pos, unsigned esym, float& rxi,
                                                 float& rxq) {
  const SeqParams& p = lp.s;
  if (p.soft) return gen_received(p, lane, (int)pos, esym, rxi, rxq);
  unsigned fmask = 0;
  for (int k = 0; k < p.symlen; ++k)
    fmask |= (unsigned)((coord_bits(lane, pos, p.seed, seq_salt(1u + k)) >> 1) <
                        lp.flip_below) << k;
  return esym ^ fmask;
}

// Expected symbol of the K-bit register reg for M given at run time.
__device__ __forceinline__ unsigned esym_runtime(const LongframeParams& p, unsigned reg) {
  if (p.esym_packed)
    return (unsigned)(p.esym_tab >> (reg * (unsigned)p.s.symlen)) & (unsigned)(p.s.M - 1);
  return seq_esym(reg, p.s);
}

// The scratch of one lane: decision item q holds rows t = (q + W/P) P + i,
// i < P, of the rows W .. Tw-1 (aligned to multiples of P, so a row's word
// and shift follow from t alone; rows below W in the first item are
// stored and never read); info word j holds the info bits of rows
// 32 (j + W/32) .. + 31 (bits outside the payload rows are stored and
// never counted).
struct Scratch {
  unsigned* dec;    // this lane's first decision word (and thread's word of a row)
  unsigned* info;   // this lane's first info word
  unsigned iacc = 0;
};

__device__ __forceinline__ Scratch scratch_start(unsigned* dec, unsigned* info, size_t first,
                                                 size_t lane) {
  Scratch sc;
  sc.dec = dec + first;
  sc.info = info + lane;
  return sc;
}

// The info bit of row t: packed by absolute row, a word stored when its
// last row is done.
__device__ __forceinline__ void store_info_bit(const LongframeParams& p, int t, unsigned bit,
                                               bool owner, Scratch& sc) {
  sc.iacc |= bit << (t & 31);
  if ((t & 31) == 31 || t == p.Tw - 1) {
    const int j = (t >> 5) - (p.W >> 5);
    if (owner && j >= 0 && (t & ~31) < p.W + p.Wn) sc.info[(size_t)j * p.lanes] = sc.iacc;
    sc.iacc = 0;
  }
}

// Symbol row t of a window whose row 0 is stream position base: advance the
// encoder, draw the channel, run one ACS step src -> dst, and store the
// decisions (rows t >= W; S < 32: packed into acc, shift (t mod P) S, the
// word stored with its last row) and the info bit.
template <int S, int M>
__device__ __forceinline__ void window_step(const LongframeParams& p, unsigned lane,
                                            unsigned base, int t, unsigned& reg,
                                            const float (&src)[S], float (&dst)[S],
                                            float* bmcol, unsigned& acc, Scratch& sc) {
  using Pk = Pack<S>;
  const unsigned pos = base + (unsigned)t;
  const unsigned bit = stream_bit(p.s, lane, pos);
  reg = (reg >> 1) | (bit << (p.s.K - 1));
  unsigned words[Pk::NW];
  if constexpr (M == 0) {   // M at run time: the metrics computed where read
    float rxi = 0.0f, rxq = 0.0f;
    const unsigned rx = received_row(p, lane, pos, esym_runtime(p, reg), rxi, rxq);
    if (p.s.soft)
      acs_step_fn<S>(src, dst, [&](unsigned e) {
        return point_dist(p.s, rxi, rxq, p.s.px[e], p.s.py[e]);
      }, false, p.tt, words);
    else
      acs_step_fn<S>(src, dst, [&](unsigned e) { return (float)__popc(rx ^ e); }, true, p.tt,
                     words);
  } else {
    float bm[M];
    branch_metrics<M>(p, lane, pos, esym_of<M>(p, reg), bm);
#pragma unroll
    for (int e = 0; e < M; ++e) bmcol[e * kThreads] = bm[e];
    acs_step_smem<S, kThreads>(src, dst, bmcol, !p.s.soft, p.tt, words);
  }
  const size_t lanes = (size_t)p.lanes;
  if constexpr (Pk::P > 1) {
    const int i = t & (Pk::P - 1);
    acc |= words[0] << (i * S);
    if (i == Pk::P - 1 || t == p.Tw - 1) {
      if (t >= p.W) sc.dec[(size_t)(t / Pk::P - p.W / Pk::P) * lanes] = acc;
      acc = 0;
    }
  } else if (t >= p.W) {
#pragma unroll
    for (int w = 0; w < Pk::NW; ++w) sc.dec[((size_t)(t - p.W) * Pk::NW + w) * lanes] = words[w];
  }
  store_info_bit(p, t, bit, true, sc);
}

// Traceback state of one window: survivor state, errors, the decoded
// payload bits of the current 32-row word, and the info words now and
// next.
struct WalkState {
  unsigned cur;
  int err = 0;
  unsigned dacc = 0, icur = 0, inext = 0;
};

// Payload rows t of one 32-row word are done (t = its lowest row walked):
// count the decoded bits that differ from the stored info bits (loaded a
// word ahead).
__device__ __forceinline__ void tb_flush(const LongframeParams& p, int t,
                                         const unsigned* __restrict__ info, WalkState& ws) {
  const int j = t >> 5;
  const int lo = max(p.W, 32 * j) - 32 * j, hi = min(p.W + p.Wn, 32 * j + 32) - 32 * j;
  const unsigned pmask = (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
  ws.err += __popc((ws.dacc ^ ws.icur) & pmask);
  ws.icur = ws.inext;
  const int jn = j - 2 - (p.W >> 5);
  ws.inext = jn >= 0 ? info[(size_t)jn * p.lanes] : 0u;
  ws.dacc = 0;
}

// The traceback of one window from end state cur: rows Tw-1 down to W, one
// row an iteration (a short loop: many warps per SM hide the loads, and
// unrolled walks that load ahead were slower).  Returns the payload bit
// errors.
template <int S>
__device__ __forceinline__ int window_traceback(const LongframeParams& p, unsigned cur,
                                                const unsigned* __restrict__ dec,
                                                const unsigned* __restrict__ info) {
  using Pk = Pack<S>;
  const size_t lanes = (size_t)p.lanes;
  const int K = p.s.K;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  WalkState ws;
  ws.cur = cur;
  const int jt = ((p.W + p.Wn - 1) >> 5) - (p.W >> 5);
  ws.icur = info[(size_t)jt * lanes];
  ws.inext = jt >= 1 ? info[(size_t)(jt - 1) * lanes] : 0u;
  unsigned w[Pk::NW];
#pragma unroll 1
  for (int t = p.Tw - 1; t >= p.W; --t) {
    const int i = t & (Pk::P - 1);
    if (i == Pk::P - 1 || t == p.Tw - 1) {
      const unsigned* item = dec + (size_t)(t / Pk::P - p.W / Pk::P) * Pk::NW * lanes;
#pragma unroll
      for (int k = 0; k < Pk::NW; ++k) w[k] = item[(size_t)k * lanes];
    }
    // select by masks, not by `?:` on the array (keeps w in registers)
    unsigned word = w[0];
    if constexpr (Pk::NW > 1) {
      word = 0;
#pragma unroll
      for (int k = 0; k < Pk::NW; ++k)
        word |= w[k] & (0u - (unsigned)((ws.cur >> 5) == (unsigned)k));
    }
    const unsigned d = (word >> (i * S + (ws.cur & 31u))) & 1u;
    if (t < p.W + p.Wn) {
      ws.dacc |= (ws.cur >> (K - 2)) << (t & 31);
      if ((t & 31) == 0 || t == p.W) tb_flush(p, t, info, ws);
    }
    ws.cur = ((ws.cur & half_mask) << 1) | d;
  }
  return ws.err;
}

// Stream position of row 0 of window `step` (mod 2^32, as the TPU
// kernel's int32 positions wrap), and the encoder register before it.
__device__ __forceinline__ unsigned window_base(const LongframeParams& p, unsigned lane,
                                                int step, unsigned& reg) {
  const unsigned base = (unsigned)(p.win0 + step) * (unsigned)p.Wn - (unsigned)p.W;
  const int K = p.s.K;
  reg = 0;
  for (int j = 0; j < K - 1; ++j)   // the K-1 lead-in bits
    reg = (reg >> 1) | (stream_bit(p.s, lane, base - (unsigned)(K - 1 - j)) << (K - 1));
  return base;
}

// One thread per lane, all S metrics in registers.  S <= 8 is compiled for
// 8 blocks per SM (at most 64 registers; left free, ptxas spilled the
// S = 4, M = 8 instance at 56), S = 16 for 6 (80 registers: the S = 16,
// M = 2 instance spilled at 64); the instances for M at run time (M = 0)
// for 6 up to S = 16.
template <int S, int M>
__global__ void __launch_bounds__(kThreads, M > 0 && S <= 8 ? 8 : (S <= 16 ? 6 : 1))
mc_longframe_kernel(int* __restrict__ out, unsigned* __restrict__ scratch,
                    unsigned* __restrict__ info, const __grid_constant__ LongframeParams p) {
  // [e][thread]: the row's branch metrics (unused for M at run time)
  __shared__ float bm_s[(M > 0 ? M : 1) * kThreads];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.lanes) return;
  const unsigned lane = (unsigned)g;
  float* bmcol = bm_s + threadIdx.x;
  int errs = 0, werrs = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    unsigned reg;
    const unsigned base = window_base(p, lane, step, reg);
    Scratch sc = scratch_start(scratch, info, lane, lane);
    float ma[S], mb[S];
#pragma unroll
    for (int s = 0; s < S; ++s) ma[s] = 0.0f;   // uniform start: the left halo warms up
    unsigned acc = 0;
    int t = 0;
    for (; t + 1 < p.Tw; t += 2) {
      window_step<S, M>(p, lane, base, t, reg, ma, mb, bmcol, acc, sc);
      window_step<S, M>(p, lane, base, t + 1, reg, mb, ma, bmcol, acc, sc);
    }
    unsigned cur;
    if (t < p.Tw) {
      window_step<S, M>(p, lane, base, t, reg, ma, mb, bmcol, acc, sc);
      cur = argmin_state<S>(mb);
    } else {
      cur = argmin_state<S>(ma);
    }
    const int err = window_traceback<S>(p, cur, scratch + lane, info + lane);
    errs += err;
    werrs += err > 0;
  }
  out[g] = errs;
  out[(size_t)p.lanes + g] = werrs;
}

// One ACS step of a lane's group: thread r holds states r SPT + k, k < SPT;
// the row's branch metrics are read from the group's row in shared memory.
template <int S, int M, int G>
__device__ __forceinline__ void group_acs_step(const float (&src)[S / G], float (&dst)[S / G],
                                               const float* bmrow, bool hard,
                                               const unsigned (&esp)[(S / G + 3) / 4],
                                               int pred_lane, unsigned& dbits) {
  constexpr int SPT = S / G;
  float pr[2 * SPT];   // metrics of states 2 (r mod G/2) SPT .. + 2 SPT
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    pr[i] = __shfl_sync(kFull, src[i], pred_lane);
    pr[SPT + i] = __shfl_sync(kFull, src[i], pred_lane + 1);
  }
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const unsigned e = (esp[k / 4] >> (8 * (k % 4))) & 0xFFu;
    float c0 = pr[2 * k] + bmrow[e & 15u];
    float c1 = pr[2 * k + 1] + bmrow[e >> 4];
    if (hard) {
      c0 = fminf(c0, CC_HARD_SAT);
      c1 = fminf(c1, CC_HARD_SAT);
    }
    const bool d = c1 < c0;   // strict: ties keep branch 0
    dst[k] = d ? c1 : c0;
    word |= (unsigned)d << k;
  }
  dbits = word;
}

// The same step for M at run time (M = 0): the row's received symbol or
// point `row` (shared memory), each transition's metric computed where it
// is read (SOFT: point_dist to the point in pts, shared memory; else the
// Hamming distance, saturated), the expected symbols 8 bits each in esp.
template <int S, int G, bool SOFT>
__device__ __forceinline__ void group_acs_step_wide(const float (&src)[S / G],
                                                    float (&dst)[S / G], const float2* row,
                                                    const float2* pts, const SeqParams& p,
                                                    const unsigned (&esp)[(S / G + 1) / 2],
                                                    int pred_lane, unsigned& dbits) {
  constexpr int SPT = S / G;
  float pr[2 * SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    pr[i] = __shfl_sync(kFull, src[i], pred_lane);
    pr[SPT + i] = __shfl_sync(kFull, src[i], pred_lane + 1);
  }
  const float2 r = *row;
  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const unsigned e = (esp[k / 2] >> (16 * (k % 2))) & 0xFFFFu;
    const unsigned e0 = e & 0xFFu, e1 = e >> 8;
    float c0, c1;
    if constexpr (SOFT) {
      c0 = pr[2 * k] + point_dist(p, r.x, r.y, pts[e0].x, pts[e0].y);
      c1 = pr[2 * k + 1] + point_dist(p, r.x, r.y, pts[e1].x, pts[e1].y);
    } else {
      const unsigned rx = __float_as_uint(r.x);
      c0 = fminf(pr[2 * k] + (float)__popc(rx ^ e0), CC_HARD_SAT);
      c1 = fminf(pr[2 * k + 1] + (float)__popc(rx ^ e1), CC_HARD_SAT);
    }
    const bool d = c1 < c0;   // strict: ties keep branch 0
    dst[k] = d ? c1 : c0;
    word |= (unsigned)d << k;
  }
  dbits = word;
}

// Row t of the group: ACS src -> dst with the row's branch metrics bmrow
// (shared memory), then the decision word assembled across the threads
// that share it and stored by the first of them, and the info bit (stored
// by thread 0).
template <int S, int M, int G>
__device__ __forceinline__ void group_row(const LongframeParams& p, bool valid, int rg, int t,
                                          unsigned bit, const float (&src)[S / G],
                                          float (&dst)[S / G], const float* bmrow,
                                          const unsigned (&esp)[(S / G + 3) / 4],
                                          int pred_lane, Scratch& sc) {
  constexpr int SPT = S / G;
  constexpr int SHARE = 32 / SPT;   // threads whose bits make one word
  unsigned dbits;
  group_acs_step<S, M, G>(src, dst, bmrow, !p.s.soft, esp, pred_lane, dbits);
  unsigned word = SPT == 32 ? dbits : dbits << ((rg * SPT) & 31);
#pragma unroll
  for (int off = 1; off < SHARE; off <<= 1) word |= __shfl_xor_sync(kFull, word, off);
  if (valid && t >= p.W && ((rg * SPT) & 31) == 0)
    sc.dec[(size_t)(t - p.W) * Pack<S>::NW * p.lanes] = word;
  store_info_bit(p, t, bit, valid && rg == 0, sc);
}

// group_row for M at run time: group_acs_step_wide on the row's received
// symbol or point.
template <int S, int G, bool SOFT>
__device__ __forceinline__ void group_row_wide(const LongframeParams& p, bool valid, int rg,
                                               int t, unsigned bit, const float (&src)[S / G],
                                               float (&dst)[S / G], const float2* row,
                                               const float2* pts,
                                               const unsigned (&esp)[(S / G + 1) / 2],
                                               int pred_lane, Scratch& sc) {
  constexpr int SPT = S / G;
  constexpr int SHARE = 32 / SPT;
  unsigned dbits;
  group_acs_step_wide<S, G, SOFT>(src, dst, row, pts, p.s, esp, pred_lane, dbits);
  unsigned word = SPT == 32 ? dbits : dbits << ((rg * SPT) & 31);
#pragma unroll
  for (int off = 1; off < SHARE; off <<= 1) word |= __shfl_xor_sync(kFull, word, off);
  if (valid && t >= p.W && ((rg * SPT) & 31) == 0)
    sc.dec[(size_t)(t - p.W) * Pack<S>::NW * p.lanes] = word;
  store_info_bit(p, t, bit, valid && rg == 0, sc);
}

// First state of least metric among thread rg's states rg SPT + k.
template <int SPT>
__device__ __forceinline__ void thread_argmin(const float (&m)[SPT], int rg, float& best,
                                              unsigned& cur) {
  best = m[0];
  cur = (unsigned)(rg * SPT);
#pragma unroll
  for (int k = 1; k < SPT; ++k) {
    if (m[k] < best) {
      best = m[k];
      cur = (unsigned)(rg * SPT + k);
    }
  }
}

// G = S / 32 threads per lane (S >= 128), compiled for 2 blocks of 128 per
// SM (at most 255 registers).  The group draws G rows' symbols at once,
// thread r row t0 + r, and leaves their branch metrics in shared memory
// ([row][group][e] per warp, no bank conflicts), or for M at run time (M =
// 0) their received symbols or points ([row][group], two words each) and
// the constellation beside them; all G threads walk the traceback (the
// same loads), thread 0 writes the counters.
template <int S, int M, int G>
__global__ void __launch_bounds__(kThreads, 2)
mc_longframe_group_kernel(int* __restrict__ out, unsigned* __restrict__ scratch,
                          unsigned* __restrict__ info,
                          const __grid_constant__ LongframeParams p) {
  constexpr int SPT = S / G;
  static_assert(G >= 2 && SPT == 32 && 32 % G == 0, "group layout");
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int rg = gt % G;                       // thread within the group
  const unsigned lane = (unsigned)(gt / G);
  const bool valid = lane < (unsigned)p.lanes;  // whole groups are valid or not
  constexpr int MW = M > 0 ? M : 2;   // words of a row: M metrics, or a symbol or point
  __shared__ __align__(8) float bm_s[kThreads * MW];
  __shared__ float2 pts_s[M > 0 ? 1 : CC_SEQ_MAX_POINTS];   // M at run time: the points
  const int warp_lane = threadIdx.x & 31;
  const int group_lane = warp_lane - rg;
  const int pred_lane = group_lane + 2 * (rg % (G / 2));
  // this group's row k of the warp's branch metrics: bm_g + k (32/G) MW
  const float* bm_g = bm_s + (threadIdx.x & ~31) * MW + (warp_lane / G) * MW;
  float* bm_mine = bm_s + (threadIdx.x & ~31) * MW + (rg * (32 / G) + warp_lane / G) * MW;
  // the expected symbols of the thread's states: 4 bits each (M <= 8), or
  // 8 (M at run time)
  constexpr int EB = M > 0 ? 4 : 8, SPW = 32 / (2 * EB);
  unsigned esp[(SPT + SPW - 1) / SPW];
#pragma unroll
  for (int i = 0; i < (SPT + SPW - 1) / SPW; ++i) esp[i] = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int ns = rg * SPT + k;
    esp[k / SPW] |= ((unsigned)p.tt.esym0[ns] | ((unsigned)p.tt.esym1[ns] << EB))
                    << (2 * EB * (k % SPW));
  }
  if constexpr (M == 0) {
    for (int e = threadIdx.x; e < p.s.M; e += kThreads)
      pts_s[e] = make_float2(p.s.px[e], p.s.py[e]);
    __syncthreads();
  }
  const int K = p.s.K;
  int errs = 0, werrs = 0;

  for (int step = 0; step < p.nsteps; ++step) {
    unsigned reg;
    const unsigned base = window_base(p, lane, step, reg);
    Scratch sc = scratch_start(scratch, info, ((size_t)(rg * SPT) >> 5) * p.lanes + lane, lane);
    float ma[SPT], mb[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) ma[k] = 0.0f;
    for (int t0 = 0; t0 < p.Tw; t0 += G) {
      // thread rg draws row t0 + rg (rows past Tw are drawn and unused)
      const unsigned pos = base + (unsigned)(t0 + rg);
      const unsigned mybit = stream_bit(p.s, lane, pos);
      const unsigned gb = (__ballot_sync(kFull, mybit != 0u) >> group_lane) & ((1u << G) - 1u);
      unsigned myreg = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        reg = (reg >> 1) | (((gb >> i) & 1u) << (K - 1));
        myreg = i == rg ? reg : myreg;
      }
      if constexpr (M == 0) {
        float rxi = 0.0f, rxq = 0.0f;
        const unsigned rx = received_row(p, lane, pos, esym_runtime(p, myreg), rxi, rxq);
        __syncwarp();   // the last chunk's rows are read
        *reinterpret_cast<float2*>(bm_mine) =
            p.s.soft ? make_float2(rxi, rxq) : make_float2(__uint_as_float(rx), 0.0f);
        __syncwarp();
        const float2* rows = reinterpret_cast<const float2*>(bm_g);
        if (p.s.soft) {
#pragma unroll
          for (int k = 0; k < G; k += 2) {
            if (t0 + k < p.Tw)
              group_row_wide<S, G, true>(p, valid, rg, t0 + k, (gb >> k) & 1u, ma, mb,
                                         rows + k * (32 / G), pts_s, esp, pred_lane, sc);
            if (t0 + k + 1 < p.Tw)
              group_row_wide<S, G, true>(p, valid, rg, t0 + k + 1, (gb >> (k + 1)) & 1u, mb,
                                         ma, rows + (k + 1) * (32 / G), pts_s, esp, pred_lane,
                                         sc);
          }
        } else {
#pragma unroll
          for (int k = 0; k < G; k += 2) {
            if (t0 + k < p.Tw)
              group_row_wide<S, G, false>(p, valid, rg, t0 + k, (gb >> k) & 1u, ma, mb,
                                          rows + k * (32 / G), pts_s, esp, pred_lane, sc);
            if (t0 + k + 1 < p.Tw)
              group_row_wide<S, G, false>(p, valid, rg, t0 + k + 1, (gb >> (k + 1)) & 1u, mb,
                                          ma, rows + (k + 1) * (32 / G), pts_s, esp,
                                          pred_lane, sc);
          }
        }
      } else {
        float bmr[M];
        branch_metrics<M>(p, lane, pos, esym_of<M>(p, myreg), bmr);
        __syncwarp();   // the last chunk's rows are read
#pragma unroll
        for (int e = 0; e < M; ++e) bm_mine[e] = bmr[e];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < G; k += 2) {
          if (t0 + k < p.Tw)
            group_row<S, M, G>(p, valid, rg, t0 + k, (gb >> k) & 1u, ma, mb,
                               bm_g + k * (32 / G) * M, esp, pred_lane, sc);
          if (t0 + k + 1 < p.Tw)
            group_row<S, M, G>(p, valid, rg, t0 + k + 1, (gb >> (k + 1)) & 1u, mb, ma,
                               bm_g + (k + 1) * (32 / G) * M, esp, pred_lane, sc);
        }
      }
    }
    // first state of least metric: within the thread, then across the
    // group by (metric, state), both strict
    float best;
    unsigned cur;
    if (p.Tw & 1)
      thread_argmin<SPT>(mb, rg, best, cur);
    else
      thread_argmin<SPT>(ma, rg, best, cur);
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const unsigned oc = __shfl_xor_sync(kFull, cur, off);
      if (ob < best || (ob == best && oc < cur)) {
        best = ob;
        cur = oc;
      }
    }
    if (valid) {
      const int err = window_traceback<S>(p, cur, scratch + lane, info + lane);
      errs += err;
      werrs += err > 0;
    }
  }
  if (valid && rg == 0) {
    out[lane] = errs;
    out[(size_t)p.lanes + lane] = werrs;
  }
}

// The instances: one thread per lane up to S = 64, groups of S / 32
// threads from S = 128.
template <int S, int M>
int launch_longframe(dim3 grid, cudaStream_t stream, int* out, unsigned* scratch,
                     unsigned* info, const LongframeParams& p) {
  if constexpr (S <= 64)
    mc_longframe_kernel<S, M><<<grid, kThreads, 0, stream>>>(out, scratch, info, p);
  else
    mc_longframe_group_kernel<S, M, S / 32><<<grid, kThreads, 0, stream>>>(out, scratch, info,
                                                                         p);
  return 0;
}

}  // namespace

extern "C" {

// out [2, lanes] int32 (bit errors, windows with an error, per lane);
// scratch: the decision rows t >= W, Tw = Wn + 2W, as [ceil(Tw / P) -
// floor(W / P), ceil(S/32), lanes] 32-bit words, P = max(1, 32 / S) rows a
// word, item q holding rows (q + floor(W / P)) P ..; info: the info bits
// of rows 32 (j + floor(W / 32)) .. + 31 as word j of [floor((W + Wn - 1)
// / 32) - floor(W / 32) + 1, lanes].  flip_below: a BSC coded bit flips
// where its draw's 31-bit integer is below it
// (ops/fused_chain.flip_threshold).  group: threads per lane, which
// must be 1 up to S = 64 and S / 32 from S = 128
// (ops/fused_longframe.threads_per_lane).  Host arrays: esym_prev
// [S, 2] int32, points [M, 2] float32, polys [symlen] uint32.  Returns
// cudaGetLastError().
int cc_mc_longframe(int* out, unsigned* scratch, unsigned* info, int lanes, int nsteps,
                    int win0, int W, int Wn, unsigned seed, float param, int soft, int snap,
                    int K, int symlen, const int* esym_prev, const float* points,
                    const unsigned* polys, unsigned qmask, float inv_nd, unsigned flip_below,
                    int group, cudaStream_t stream) {
  const int S = 1 << (K - 1);
  const int M = 1 << symlen;
  const int Tw = Wn + 2 * W;
  if (lanes <= 0 || nsteps < 0 || W < 0 || Wn <= 0 || S > CC_MAX_STATES || info == nullptr ||
      group != (S <= 64 ? 1 : S / 32))
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
  p.flip_below = flip_below;
  p.esym_tab = pack_esym_table(K, symlen, polys, qmask, &p.esym_packed);
  const long long threads = (long long)lanes * group;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  int status = 0;
#define CC_LAUNCH_LONGFRAME(S_, M_) \
  status = launch_longframe<S_, M_>(grid, stream, out, scratch, info, p)
  if (M <= CC_MAX_POINTS) {
    CC_DISPATCH(S, M, CC_LAUNCH_LONGFRAME)
  } else {   // M = 16-256 (fill_seq_params took symlen <= 8): M at run time
    CC_DISPATCH_S(S, M, CC_LAUNCH_LONGFRAME, CC_DISPATCH_RUNTIME_M)
  }
#undef CC_LAUNCH_LONGFRAME
  if (status) return status;
  return (int)cudaGetLastError();
}

}  // extern "C"
