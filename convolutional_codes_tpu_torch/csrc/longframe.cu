// Viterbi add-compare-select and traceback kernels for Hopper (sm_90a):
// the decode of supplied frames, short terminated blocks and streams of
// any length alike.
//
// Replace four TPU kernels: convolutional_codes_tpu/ops/viterbi_pallas.py
// `_acs_kernel` (:86, entry acs_forward_pallas :157) and `_traceback_kernel`
// (:207, entry traceback_pallas :232), and longframe_pallas.py :142 (body
// of stream_acs_pallas :112) and :218 (body of stream_traceback_pallas
// :192).  The TPU's streaming kernels cut the frame into VMEM time chunks
// and carry the [S, B] metrics (or the survivor state) across grid steps;
// here one launch walks the whole frame, so one pair of kernels serves
// blocks of T = 42 and streams of T = 65,536.
//
// stream_acs.  What bounds it on the H100: a frame is a chain of T
// dependent trellis steps, each about 8 S operations on M floats in and
// S/32 decision words out.  One thread per frame, which does the S states
// of a step one after the other, leaves B = 128 or 1,024 long frames (the
// real-data shapes) at 128 or 1,024 threads on 132 SMs, and spills the
// metrics of S >= 128 to local memory at any B.  So the work is laid out
// by state: one thread per (frame, butterfly j), which computes new states
// j and j + S/2 from their common predecessors 2j and 2j+1 with the same
// float operations as ops/viterbi.acs_scan (c0 = m[2j] + bm[esym0], c1 =
// m[2j+1] + bm[esym1], 0xFF00 saturation in hard mode, strict-less
// select).  For S <= 64 a frame's S/2 threads sit in one warp (S < 64:
// 64/S frames per warp), the new metrics move to the threads that need
// them by warp shuffles and no barrier is needed; for S >= 128 they go
// through shared memory with one barrier per step.  Decisions are packed
// by __ballot_sync.  The distances of the next chunk of steps are loaded
// into registers while the current chunk runs from shared memory, and the
// decision words of a chunk leave through shared memory.  The serial
// chain of T steps stays; each step is a few dozen instructions of one
// warp instead of 8 S of one thread.  At B = 128 one warp a frame is all an
// SM runs, so what bounds B = 128 is the latency of one step's dependent
// chain in one warp (the time of one frame alone), not the card.  From S =
// 8 to 64 the step is pipelined (acs_pipelined).  At S = 64 with M = 2-16
// staged (acs_two_step) a body advances two steps per exchange: lane l =
// 16h + k takes the metrics of ancestors 4k .. 4k+3 in four shuffles,
// computes intermediate states 2k + 32h and 2k + 32h + 1 from them and
// final states l and l + 32 from those, so a step pair's chain pays one
// round of shuffles where the radix-2 step paid two; an odd last step of
// a frame takes one radix-2 step (stream_acs_pairs).  It keeps the 32
// threads and two states a thread of the radix-2 step and exchanges by
// shuffles with no barrier.  Groups of 2^R states a thread, R steps
// between exchanges through shared memory with a barrier, issued more
// instructions per warp and step and were slower at every shape tried (R
// = 2 and 3, S = 4 .. 256; PERF.md).  M = 32-256 has one
// instance per S with M at run time, which reads each transition's
// distance where it lies instead of staging all M (AcsChunk<S, 0>).
//
// stream_traceback.  A traceback is T dependent steps per frame, from
// given start states or from the first state of least final metric (a
// strict-less scan from state 0, so no library argmin decides a tie).
// One thread per frame walks a whole frame: that is the design where B
// frames fill the card (the modular chain's B = 262,144 short blocks).
// The addresses of a row's decision words do not depend on the survivor
// state, so every word of a group of rows is loaded before the group is
// walked, and the next group is in flight while the current one is
// walked (two register buffers of 32 words).  At B = 128 or 1,024 long
// frames that leaves 4 or 32 warps on the card, each step a dependent
// select-and-shift (~176 cycles).  A traceback is a function of its end
// state, so the frame is cut into G segments of L rows exactly: (1) every
// segment's map {end state -> start state} is computed from all S end
// states at once, the segment's decisions staged in shared memory; (2) per
// frame the maps are folded from the last segment back, which gives each
// segment's true end state; (3) each segment walks its L rows again from
// that state, as one frame of the per-frame design.  The bits and the
// carry are the per-frame walk's by construction.  ops/viterbi_cuda.
// traceback_plan chooses the design and L.
#include "acs.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Thread layout of stream_acs for S states: H = S/2 threads per frame.
template <int S>
struct AcsLayout {
  static constexpr int H = S / 2;
  static constexpr int THREADS = H < 32 ? 32 : H;   // threads per block
  static constexpr int FPB = H < 32 ? 32 / H : 1;   // frames per block
  static constexpr int NW = (S + 31) / 32;          // decision words per step
};

// Steps staged per chunk: about 8 distance floats per thread.
template <int S, int M>
struct AcsChunk {
  using L = AcsLayout<S>;
  static constexpr int CH0 = 8 * L::THREADS / (M * L::FPB);
  static constexpr int CH = CH0 < 1 ? 1 : CH0;
  static constexpr int ELEMS = CH * M * L::FPB;     // floats of a chunk
  static constexpr int PER = (ELEMS + L::THREADS - 1) / L::THREADS;
};

// M at run time (the instances <S, 0>, for M = 32-256): a chunk of M
// distances a frame would not fit the registers (S = 4, M = 256: 128 floats
// a thread), and a step reads at most 2S of the M columns, so each thread
// reads its transitions' distances where they lie, dists[(t M + e) B + b],
// coalesced over a block's frames; chunks of 32 steps stage only the
// decision words.
template <int S>
struct AcsChunk<S, 0> {
  static constexpr int CH = 32, ELEMS = 1, PER = 1;
};

// Load the [CH, M, FPB] distances of steps t0.. of the block's frames
// into registers (zeros past T or B).
template <int S, int M>
__device__ __forceinline__ void load_chunk(float (&pre)[AcsChunk<S, M>::PER],
                                           const float* __restrict__ dists, int t0, int T,
                                           int b0, int B) {
  using L = AcsLayout<S>;
  using C = AcsChunk<S, M>;
#pragma unroll
  for (int k = 0; k < C::PER; ++k) {
    const int i = threadIdx.x + k * L::THREADS;
    const int f = i % L::FPB, e = (i / L::FPB) % M, t = t0 + i / (L::FPB * M);
    pre[k] = (i < C::ELEMS && t < T && b0 + f < B)
                 ? dists[((size_t)t * M + e) * (size_t)B + b0 + f]
                 : 0.0f;
  }
}

template <int S, int M>
__device__ __forceinline__ void store_chunk(float* buf,
                                            const float (&pre)[AcsChunk<S, M>::PER]) {
  using L = AcsLayout<S>;
  using C = AcsChunk<S, M>;
#pragma unroll
  for (int k = 0; k < C::PER; ++k) {
    const int i = threadIdx.x + k * L::THREADS;
    if (i < C::ELEMS) buf[i] = pre[k];
  }
}

// From S = 8 to 64 (a frame's threads in one warp) the step is pipelined:
// the next step's branch metrics are loaded while this step runs, and the
// metrics move by two shuffles instead of four (each lane sends first the
// value its first reader needs).  At S = 4 the two shuffles made kernel 1
// (code 0, 262,144 frames of 42 steps) 6% slower, 10% with the prefetch;
// the prefetch alone was 3% slower at S = 128 (PERF.md).
template <int S>
__host__ __device__ constexpr bool acs_pipelined() {
  return S >= 8 && S <= 64;
}

// Hard mode (0xFF00 saturation) is compiled in from S = 64 (HARD): as a
// runtime flag there, soft and hard frames ran 4-14% slower (S = 64 to
// 256).  Below S = 64 it is a runtime flag: compiled in, kernel 1 (S = 4)
// was 7% slower (PERF.md).
template <int S>
__host__ __device__ constexpr bool acs_hard_compiled() {
  return S >= 64;
}

// S = 64 with M = 2-16 staged in shared memory: two trellis steps per
// exchange of path metrics (stream_acs_pairs).
template <int S, int M>
__host__ __device__ constexpr bool acs_two_step() {
  return S == 64 && M > 0;
}

template <bool HARD>
__device__ __forceinline__ float acs_select(float m0, float m1, float x0, float x1, bool& d) {
  float c0 = m0 + x0, c1 = m1 + x1;
  if (HARD) {
    c0 = fminf(c0, CC_HARD_SAT);
    c1 = fminf(c1, CC_HARD_SAT);
  }
  d = c1 < c0;   // strict: ties keep branch 0
  return d ? c1 : c0;
}

// The lanes whose V holds their high state (bit 1 of the lane set).
constexpr unsigned kPairSwap = 0xCCCCCCCCu;

// The low 16 bits of x to the even bits of a word.
__device__ __forceinline__ unsigned spread16(unsigned x) {
  x &= 0xFFFFu;
  x = (x | (x << 8)) & 0x00FF00FFu;
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  x = (x | (x << 2)) & 0x33333333u;
  return (x | (x << 1)) & 0x55555555u;
}

// Decision word w of a row from the row's two raw ballots: (X, Y) of a
// pair's first step, interleaved (word h, bit 2k: state 2k + 32h, lane 16h
// + k's X; bit 2k+1: state 2k + 32h + 1, its Y), or (V, W) of a pair's
// second step or of a radix-2 step (bit l of word 0: state l, in V unless
// bit 1 of l is set).
__device__ __forceinline__ unsigned pair_word(unsigned a, unsigned b, int w, bool first) {
  if (first) return spread16(a >> (16 * w)) | (spread16(b >> (16 * w)) << 1);
  return w ? (b & ~kPairSwap) | (a & kPairSwap) : (a & ~kPairSwap) | (b & kPairSwap);
}

// The two-step body: one frame a warp (block b), lane l = 16h + k.  Between
// bodies lane l holds the metrics of states l and l + 32: V, the one that
// rounds 0-1 of the exchange read (l + 32 where bit 1 of l is set, else l),
// and W the other.  A pair of steps t, t+1:
//   exchange  round r brings ancestor r (k < 8; from lane 4k + r) or (r +
//             2) & 3 (k >= 8; from lane 4(k-8) + ((r+2) & 3)), rounds 0-1
//             from V, 2-3 from W: every lane sends one value a round, and
//             the lanes of a round read either their sources' low states
//             or their high ones, so no source is asked for two;
//   step t    intermediate states X = 2k + 32h (ancestors 4k, 4k+1) and Y
//             = X + 1 (4k+2, 4k+3), each with its two candidates in the
//             reference's order: lanes k >= 8 select rounds 2-3 for X and
//             0-1 for Y, so each compare waits for all four shuffles and
//             the four issue back to back;
//   step t+1  V and W from X (branch 0) and Y, the same operations.
// The four ballots of a pair go to shared memory raw and become decision
// words in the copy to dec (pair_word), off the chain.  An odd last step
// (T odd: every chunk but the last holds 256/M steps, an even number) is
// one radix-2 step from the same V/W layout: lane j takes m[2j] and
// m[2j+1] in two shuffles, each lane sending first its low state if even,
// its high one if odd (V or W by bit 0 ^ bit 1 of the lane), as the
// pipelined step does.
template <int M, bool HARD>
__device__ __forceinline__ void stream_acs_pairs(float (*bm_s)[AcsChunk<64, M>::ELEMS],
                                                 unsigned* dec_s,
                                                 const float* __restrict__ dists,
                                                 const float* __restrict__ init,
                                                 float* __restrict__ fm, int* __restrict__ dec,
                                                 int T, int B, const TrellisTables& tt) {
  using C = AcsChunk<64, M>;
  constexpr int CH = C::CH;
  const int l = threadIdx.x, b = blockIdx.x, k = l & 15;
  const size_t Bs = (size_t)B;
  const bool hi = k >= 8;
  const int sv = (kPairSwap >> l) & 1u ? l + 32 : l, sw = sv ^ 32;
  const int sx = 2 * k + 32 * (l >> 4), sy = sx + 1;
  const int q = 4 * (k & 7) + (hi ? 2 : 0);   // the source of round 0
  const int q0 = q, q1 = q + 1, q2 = q ^ 2, q3 = (q ^ 2) + 1;
  const int ex0 = tt.esym0[sx], ex1 = tt.esym1[sx], ey0 = tt.esym0[sy], ey1 = tt.esym1[sy];
  const int ev0 = tt.esym0[sv], ev1 = tt.esym1[sv], ew0 = tt.esym0[sw], ew1 = tt.esym1[sw];
  // the radix-2 step's sources and send order
  const bool lo2 = l < 16, odd2 = ((l ^ (l >> 1)) & 1) != 0;
  const int src1 = lo2 ? 2 * l : (2 * l + 1) & 31, src2 = lo2 ? 2 * l + 1 : (2 * l) & 31;
  float V = init[(size_t)sv * Bs + b], W = init[(size_t)sw * Bs + b];

  const int nchunks = (T + CH - 1) / CH;
  float pre[C::PER];
  load_chunk<64, M>(pre, dists, 0, T, b, B);
  store_chunk<64, M>(bm_s[0], pre);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * CH;
    if (c + 1 < nchunks) load_chunk<64, M>(pre, dists, t0 + CH, T, b, B);
    const float* bmc = bm_s[c & 1];
    const int steps = min(CH, T - t0), pairs = steps >> 1;
    // a pair's eight distances; the next pair's load while it runs
    float px0 = bmc[ex0], px1 = bmc[ex1], py0 = bmc[ey0], py1 = bmc[ey1];
    float pv0 = bmc[M + ev0], pv1 = bmc[M + ev1], pw0 = bmc[M + ew0], pw1 = bmc[M + ew1];
#pragma unroll 4
    for (int p = 0; p < pairs; ++p) {
      const float r0 = __shfl_sync(kFull, V, q0), r1 = __shfl_sync(kFull, V, q1);
      const float r2 = __shfl_sync(kFull, W, q2), r3 = __shfl_sync(kFull, W, q3);
      const float bx0 = px0, bx1 = px1, by0 = py0, by1 = py1;
      const float bv0 = pv0, bv1 = pv1, bw0 = pw0, bw1 = pw1;
      const float* next = bmc + min(2 * p + 2, CH - 2) * M;   // the last pair's: unused
      px0 = next[ex0], px1 = next[ex1], py0 = next[ey0], py1 = next[ey1];
      pv0 = next[M + ev0], pv1 = next[M + ev1], pw0 = next[M + ew0], pw1 = next[M + ew1];
      bool dx, dy, dv, dw;
      const float x = acs_select<HARD>(hi ? r2 : r0, hi ? r3 : r1, bx0, bx1, dx);
      const float y = acs_select<HARD>(hi ? r0 : r2, hi ? r1 : r3, by0, by1, dy);
      V = acs_select<HARD>(x, y, bv0, bv1, dv);
      W = acs_select<HARD>(x, y, bw0, bw1, dw);
      *reinterpret_cast<uint4*>(dec_s + 4 * p) =
          make_uint4(__ballot_sync(kFull, dx), __ballot_sync(kFull, dy),
                     __ballot_sync(kFull, dv), __ballot_sync(kFull, dw));
    }
    if (steps & 1) {
      const float* row = bmc + (steps - 1) * M;
      const float r1 = __shfl_sync(kFull, odd2 ? W : V, src1);
      const float r2 = __shfl_sync(kFull, odd2 ? V : W, src2);
      const float m0 = lo2 ? r1 : r2, m1 = lo2 ? r2 : r1;
      bool dv, dw;
      V = acs_select<HARD>(m0, m1, row[ev0], row[ev1], dv);
      W = acs_select<HARD>(m0, m1, row[ew0], row[ew1], dw);
      *reinterpret_cast<uint2*>(dec_s + 2 * (steps - 1)) =
          make_uint2(__ballot_sync(kFull, dv), __ballot_sync(kFull, dw));
    }
    __syncthreads();
    for (int i = l; i < 2 * steps; i += 32) {
      const int tl = i >> 1;
      const bool first = tl < 2 * pairs && !(tl & 1);
      dec[((size_t)(t0 + tl) * 2 + (i & 1)) * Bs + b] =
          (int)pair_word(dec_s[2 * tl], dec_s[2 * tl + 1], i & 1, first);
    }
    if (c + 1 < nchunks) store_chunk<64, M>(bm_s[(c + 1) & 1], pre);
    __syncthreads();
  }
  fm[(size_t)sv * Bs + b] = V;
  fm[(size_t)sw * Bs + b] = W;
}

template <int S, int M, bool HARD>
__global__ void __launch_bounds__(AcsLayout<S>::THREADS)
stream_acs_kernel(const float* __restrict__ dists, const float* __restrict__ init,
                  float* __restrict__ fm, int* __restrict__ dec, int T, int B, int hard_flag,
                  const __grid_constant__ TrellisTables tt, int Mr) {
  using L = AcsLayout<S>;
  using C = AcsChunk<S, M>;
  constexpr int H = L::H, FPB = L::FPB, NW = L::NW, CH = C::CH;
  constexpr bool PIPE = acs_pipelined<S>();
  const bool hard = acs_hard_compiled<S>() ? HARD : hard_flag != 0;
  __shared__ float bm_s[2][C::ELEMS];               // [chunk step][e][frame]
  __shared__ __align__(16) unsigned dec_s[CH * NW * FPB];   // [chunk step][word][frame]
  __shared__ float2 m_s[2][H >= 64 ? H : 1];        // metric exchange, S >= 128
  if constexpr (acs_two_step<S, M>()) {
    stream_acs_pairs<M, HARD>(bm_s, dec_s, dists, init, fm, dec, T, B, tt);
    return;
  }

  const int tid = threadIdx.x;
  const int f = tid / H;               // frame within the block
  const int j = tid % H;               // butterfly: new states j and j + H
  const int b0 = blockIdx.x * FPB;
  const int b = b0 + f;
  const bool valid = b < B;
  const size_t Bs = (size_t)B;
  const int e0a = tt.esym0[j], e1a = tt.esym1[j];
  const int e0b = tt.esym0[j + H], e1b = tt.esym1[j + H];
  float m0 = valid ? init[(size_t)(2 * j) * Bs + b] : 0.0f;       // m[2j]
  float m1 = valid ? init[(size_t)(2 * j + 1) * Bs + b] : 0.0f;   // m[2j+1]
  float na = 0.0f, nb = 0.0f;                                     // new m[j], m[j+H]
  // PIPE: thread j < H/2 reads m[2j] (the first new state of lane 2j)
  // and m[2j+1] (of lane 2j+1), thread j >= H/2 the second new states of
  // lanes 2j-H and 2j-H+1; so an even lane sends first na, then nb, an odd
  // lane first nb, then na, and two shuffles carry every metric
  const bool lo = 2 * j < H, odd = j & 1;
  const int src1 = lo ? 2 * j : (2 * j + 1) & (H - 1);
  const int src2 = lo ? 2 * j + 1 : (2 * j) & (H - 1);

  const int nchunks = (T + CH - 1) / CH;
  float pre[C::PER];
  if constexpr (M > 0) {
    load_chunk<S, M>(pre, dists, 0, T, b0, B);
    store_chunk<S, M>(bm_s[0], pre);
  }
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * CH;
    if constexpr (M > 0)
      if (c + 1 < nchunks) load_chunk<S, M>(pre, dists, t0 + CH, T, b0, B);
    const float* bmc = bm_s[c & 1] + f;
    // M at run time: this frame's distances of the chunk's first step
    const float* dcol = dists + (valid ? b : B - 1) + (size_t)t0 * Mr * Bs;
    const int steps = min(CH, T - t0);
    float p0a, p1a, p0b, p1b;
    if constexpr (M == 0) {
      p0a = dcol[e0a * Bs], p1a = dcol[e1a * Bs], p0b = dcol[e0b * Bs], p1b = dcol[e1b * Bs];
    } else {
      p0a = bmc[e0a * FPB], p1a = bmc[e1a * FPB], p0b = bmc[e0b * FPB], p1b = bmc[e1b * FPB];
    }
#pragma unroll 4   // lets the distance loads of later steps issue early
    for (int tl = 0; tl < steps; ++tl) {
      float x0a, x1a, x0b, x1b;
      if constexpr (PIPE) {
        x0a = p0a, x1a = p1a, x0b = p0b, x1b = p1b;
        if (tl + 1 < steps) {
          if constexpr (M == 0) {
            const float* next = dcol + (size_t)(tl + 1) * Mr * Bs;
            p0a = next[e0a * Bs], p1a = next[e1a * Bs], p0b = next[e0b * Bs],
            p1b = next[e1b * Bs];
          } else {
            const float* next = bmc + (tl + 1) * M * FPB;
            p0a = next[e0a * FPB], p1a = next[e1a * FPB], p0b = next[e0b * FPB],
            p1b = next[e1b * FPB];
          }
        }
      } else if constexpr (M == 0) {
        const float* row = dcol + (size_t)tl * Mr * Bs;
        x0a = row[e0a * Bs], x1a = row[e1a * Bs], x0b = row[e0b * Bs], x1b = row[e1b * Bs];
      } else {
        const float* row = bmc + tl * M * FPB;
        x0a = row[e0a * FPB], x1a = row[e1a * FPB], x0b = row[e0b * FPB], x1b = row[e1b * FPB];
      }
      float c0a = m0 + x0a, c1a = m1 + x1a;
      float c0b = m0 + x0b, c1b = m1 + x1b;
      if (hard) {
        c0a = fminf(c0a, CC_HARD_SAT);
        c1a = fminf(c1a, CC_HARD_SAT);
        c0b = fminf(c0b, CC_HARD_SAT);
        c1b = fminf(c1b, CC_HARD_SAT);
      }
      const bool da = c1a < c0a, db = c1b < c0b;   // strict: ties keep branch 0
      na = da ? c1a : c0a;
      nb = db ? c1b : c0b;
      const unsigned bf = __ballot_sync(kFull, da), bs = __ballot_sync(kFull, db);
      if constexpr (S == 64) {
        // one frame a warp: every lane stores its words 0 and 1 (no branch)
        *reinterpret_cast<uint2*>(dec_s + tl * 2) = make_uint2(bf, bs);
      } else if constexpr (H < 32) {
        // the warp holds FPB frames; frame f's states j are lanes f*H + j
        if (j == 0) {
          constexpr unsigned mask = (1u << H) - 1u;
          dec_s[tl * FPB + f] = ((bf >> (f * H)) & mask) | (((bs >> (f * H)) & mask) << H);
        }
      } else if ((tid & 31) == 0) {
        // warp k of the frame holds states 32k.. (word k) and H + 32k.. (word H/32 + k)
        const int k = tid >> 5;
        dec_s[(tl * NW + k) * FPB] = bf;
        dec_s[(tl * NW + H / 32 + k) * FPB] = bs;
      }
      if constexpr (PIPE) {
        const float r1 = __shfl_sync(kFull, odd ? nb : na, src1, H);
        const float r2 = __shfl_sync(kFull, odd ? na : nb, src2, H);
        m0 = lo ? r1 : r2;
        m1 = lo ? r2 : r1;
      } else if constexpr (H <= 32) {
        // m[2j] and m[2j+1] live in lanes 2j mod H, 2j+1 mod H, as their
        // first (index < H) or second new state
        const int s0 = (2 * j) & (H - 1), s1 = (2 * j + 1) & (H - 1);
        const float a0 = __shfl_sync(kFull, na, s0, H), q0 = __shfl_sync(kFull, nb, s0, H);
        const float a1 = __shfl_sync(kFull, na, s1, H), q1 = __shfl_sync(kFull, nb, s1, H);
        m0 = 2 * j < H ? a0 : q0;
        m1 = 2 * j + 1 < H ? a1 : q1;
      } else {
        float* mx = reinterpret_cast<float*>(m_s[(t0 + tl) & 1]);
        mx[j] = na;
        mx[j + H] = nb;
        __syncthreads();
        const float2 p = m_s[(t0 + tl) & 1][j];
        m0 = p.x;
        m1 = p.y;
      }
    }
    __syncthreads();
    for (int i = tid; i < steps * NW * FPB; i += L::THREADS) {
      const int ff = i % FPB, w = (i / FPB) % NW, tl = i / (FPB * NW);
      if (b0 + ff < B) dec[((size_t)(t0 + tl) * NW + w) * Bs + b0 + ff] = (int)dec_s[i];
    }
    if constexpr (M > 0)
      if (c + 1 < nchunks) store_chunk<S, M>(bm_s[(c + 1) & 1], pre);
    __syncthreads();
  }
  if (valid) {
    fm[(size_t)j * Bs + b] = na;
    fm[(size_t)(j + H) * Bs + b] = nb;
  }
}

constexpr int kTbThreads = 32;

// Rows per group of the traceback walk: 32 words in flight per buffer.
template <int NW>
struct TbGroup {
  static constexpr int U = 32 / NW;
};

// Rows t_hi-1-(g*U+u) of a walk down to row t_lo.
template <int NW>
__device__ __forceinline__ void tb_load(unsigned (&w)[TbGroup<NW>::U][NW],
                                        const int* __restrict__ dec, int g, int t_hi, int t_lo,
                                        size_t Bs, int b) {
#pragma unroll
  for (int u = 0; u < TbGroup<NW>::U; ++u) {
    const int t = t_hi - 1 - (g * TbGroup<NW>::U + u);
    if (t >= t_lo) {
#pragma unroll
      for (int k = 0; k < NW; ++k) w[u][k] = (unsigned)dec[((size_t)t * NW + k) * Bs + b];
    }
  }
}

template <int NW>
__device__ __forceinline__ void tb_walk(unsigned (&w)[TbGroup<NW>::U][NW],
                                        int* __restrict__ bits, int g, int t_hi, int t_lo,
                                        size_t Bs, int b, int K, unsigned half_mask,
                                        unsigned& cur) {
#pragma unroll
  for (int u = 0; u < TbGroup<NW>::U; ++u) {
    const int t = t_hi - 1 - (g * TbGroup<NW>::U + u);
    if (t >= t_lo) {
      // select by masks, not by `?:` on the array: a select of two array
      // elements may become a load from a selected address, which moves
      // the buffers to local memory
      unsigned word = 0;
#pragma unroll
      for (int k = 0; k < NW; ++k) word |= w[u][k] & (0u - (unsigned)((cur >> 5) == (unsigned)k));
      bits[(size_t)t * Bs + b] = (int)(cur >> (K - 2));
      cur = ((cur & half_mask) << 1) | ((word >> (cur & 31u)) & 1u);
    }
  }
}

// The walk: thread (frame b, segment blockIdx.y) traces rows [seg L,
// min(T, (seg+1) L)) back from its end state, start[seg B + b], or, with
// one segment and no start, from the first state of least final metric.
// The segment-0 thread writes the carry.
template <int NW>
__global__ void __launch_bounds__(kTbThreads)
stream_traceback_kernel(const int* __restrict__ dec, const int* __restrict__ start,
                        const float* __restrict__ fm, int* __restrict__ bits,
                        int* __restrict__ carry, float* __restrict__ min_metric, int T,
                        int B, int S, int K, int L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int seg = blockIdx.y;
  const int t_lo = seg * L, t_hi = min(T, t_lo + L);
  const size_t Bs = (size_t)B;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  unsigned cur;
  if (start != nullptr) {
    cur = (unsigned)start[(size_t)seg * Bs + b];
  } else {
    // the first state of least final metric, and that metric
    float best = fm[b];
    cur = 0;
    for (int s = 1; s < S; ++s) {
      const float v = fm[(size_t)s * Bs + b];
      if (v < best) {
        best = v;
        cur = (unsigned)s;
      }
    }
    min_metric[b] = best;
  }
  unsigned wa[TbGroup<NW>::U][NW], wb[TbGroup<NW>::U][NW];
  const int ng = (t_hi - t_lo + TbGroup<NW>::U - 1) / TbGroup<NW>::U;
  tb_load<NW>(wa, dec, 0, t_hi, t_lo, Bs, b);
  for (int g = 0; g < ng; g += 2) {
    tb_load<NW>(wb, dec, g + 1, t_hi, t_lo, Bs, b);
    tb_walk<NW>(wa, bits, g, t_hi, t_lo, Bs, b, K, half_mask, cur);
    tb_load<NW>(wa, dec, g + 2, t_hi, t_lo, Bs, b);
    tb_walk<NW>(wb, bits, g + 1, t_hi, t_lo, Bs, b, K, half_mask, cur);
  }
  if (carry != nullptr && seg == 0) carry[b] = (int)cur;
}

// Segment maps.  Block (frames b0.., segment seg >= 1) stages the
// segment's [L, NW, kMapFrames] decision words in shared memory (each
// row's words of 8 neighbouring frames are one 32-byte sector), then warp f
// walks frame b0+f back from every end state at once, lane l holding states
// l, l+32, ..: map[b, seg, s] = the state before row seg L on the path that
// ends in state s after the segment's last row.  Segment 0's map is never
// read: its walk gives the carry.
constexpr int kMapFrames = 8;
constexpr int kMapThreads = 32 * kMapFrames;

template <int NW>
__global__ void __launch_bounds__(kMapThreads)
tb_map_kernel(const int* __restrict__ dec, unsigned char* __restrict__ map, int T, int B,
              int S, int L, int G) {
  extern __shared__ unsigned dec_s[];   // [row][word][frame]
  const int b0 = blockIdx.x * kMapFrames;
  const int seg = blockIdx.y + 1;
  const int t_lo = seg * L, n = min(T, t_lo + L) - t_lo;
  const size_t Bs = (size_t)B;
  for (int i = threadIdx.x; i < n * NW * kMapFrames; i += kMapThreads) {
    const int f = i % kMapFrames, w = (i / kMapFrames) % NW, tl = i / (kMapFrames * NW);
    dec_s[i] = b0 + f < B ? (unsigned)dec[((size_t)(t_lo + tl) * NW + w) * Bs + b0 + f] : 0u;
  }
  __syncthreads();
  const int f = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (b0 + f >= B || lane >= S) return;
  const unsigned half_mask = (unsigned)(S >> 1) - 1u;
  unsigned cur[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) cur[k] = (unsigned)(lane + 32 * k);
  const unsigned* col = dec_s + f;
#pragma unroll 4
  for (int tl = n - 1; tl >= 0; --tl) {
    const unsigned* row = col + tl * NW * kMapFrames;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const unsigned word = row[(cur[k] >> 5) * kMapFrames];
      cur[k] = ((cur[k] & half_mask) << 1) | ((word >> (cur[k] & 31u)) & 1u);
    }
  }
  unsigned char* out = map + ((size_t)(b0 + f) * G + seg) * S;
#pragma unroll
  for (int k = 0; k < NW; ++k) out[lane + 32 * k] = (unsigned char)cur[k];
}

// Composition: block b folds frame b's maps from the last segment back.
// The frame's end state (start[b], or the first state of least final
// metric, whose metric goes to min_metric) ends segment G-1, and
// ends[g-1, b] = map[b, g, ends[g, b]].  The maps are staged in shared
// memory kFoldBytes at a time, so each of the G-1 dependent lookups is a
// shared-memory load.
constexpr int kFoldThreads = 256;
constexpr int kFoldBytes = 16384;

__global__ void __launch_bounds__(kFoldThreads)
tb_fold_kernel(const unsigned char* __restrict__ map, const int* __restrict__ start,
               const float* __restrict__ fm, int* __restrict__ ends,
               float* __restrict__ min_metric, int B, int S, int G) {
  __shared__ unsigned char m_s[kFoldBytes];
  __shared__ float fm_s[CC_MAX_STATES];
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t Bs = (size_t)B;
  unsigned cur = 0;
  if (start != nullptr) {
    cur = (unsigned)start[b];
  } else {
    for (int s = tid; s < S; s += kFoldThreads) fm_s[s] = fm[(size_t)s * Bs + b];
    __syncthreads();
    if (tid == 0) {
      float best = fm_s[0];
      for (int s = 1; s < S; ++s) {
        if (fm_s[s] < best) {
          best = fm_s[s];
          cur = (unsigned)s;
        }
      }
      min_metric[b] = best;
    }
  }
  if (tid == 0) ends[(size_t)(G - 1) * Bs + b] = (int)cur;
  const int per = kFoldBytes / S;   // maps per chunk
  const unsigned char* mb = map + (size_t)b * G * S;
  for (int hi = G - 1; hi >= 1; hi -= per) {
    const int lo = max(1, hi - per + 1);
    __syncthreads();   // the previous chunk has been walked
    for (int i = tid; i < (hi - lo + 1) * S; i += kFoldThreads) m_s[i] = mb[(size_t)lo * S + i];
    __syncthreads();
    if (tid == 0) {
      for (int g = hi; g >= lo; --g) {
        cur = m_s[(g - lo) * S + cur];
        ends[(size_t)(g - 1) * Bs + b] = (int)cur;
      }
    }
  }
}

template <int S, int M>
void launch_stream_acs(const float* dists, const float* init, float* fm, int* dec, int T, int B,
                       int hard, const TrellisTables& tt, int Mr, cudaStream_t stream) {
  using L = AcsLayout<S>;
  const int blocks = (B + L::FPB - 1) / L::FPB;
  if (acs_hard_compiled<S>() && hard)
    stream_acs_kernel<S, M, acs_hard_compiled<S>()>
        <<<blocks, L::THREADS, 0, stream>>>(dists, init, fm, dec, T, B, hard, tt, Mr);
  else
    stream_acs_kernel<S, M, false><<<blocks, L::THREADS, 0, stream>>>(dists, init, fm, dec, T, B,
                                                                     hard, tt, Mr);
}

}  // namespace

extern "C" {

// dists [T, M, B] f32, init [S, B] f32 -> fm [S, B] f32, dec [T, nwords, B]
// i32; M = 2-16 has an instance of its own, M = 32-256 one instance per S
// (M at run time).  esym_prev: host [S, 2] int32.  Returns
// cudaGetLastError().
int cc_stream_acs(const float* dists, const float* init, float* fm, int* dec, int T, int M,
                  int B, int S, int hard, const int* esym_prev, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S < 2 || S > CC_MAX_STATES || M < 2 || M > 256 || (M & (M - 1)))
    return cudaErrorInvalidValue;
  TrellisTables tt;
  fill_trellis(&tt, esym_prev, S);
#define CC_LAUNCH_STREAM_ACS(S_, M_) \
  launch_stream_acs<S_, M_>(dists, init, fm, dec, T, B, hard, tt, M, stream)
  if (M <= 16) {
    CC_DISPATCH16(S, M, CC_LAUNCH_STREAM_ACS)
  } else {
    CC_DISPATCH_S(S, M, CC_LAUNCH_STREAM_ACS, CC_DISPATCH_RUNTIME_M)
  }
#undef CC_LAUNCH_STREAM_ACS
  return (int)cudaGetLastError();
}

// dec [T, nwords, B] i32 -> bits [T, B] i32 and carry [B] i32 (the state
// before row 0; may be null), traced back from start [B] i32 or, when
// start is null, from the first state of least metric in fm [S, B] f32,
// whose metric goes to min_metric [B] f32.  L: rows per segment.  With
// G = ceil(T / L) = 1 each frame is one walk; with G > 1 the segment maps
// go to map [B, G, S] u8, their composition to ends [G, B] i32, and the
// G walks per frame start from there (both scratch arrays from the
// caller).  Returns cudaGetLastError().
int cc_stream_traceback(const int* dec, const int* start, const float* fm, int* bits,
                        int* carry, float* min_metric, unsigned char* map, int* ends, int T,
                        int B, int S, int K, int nwords, int L, cudaStream_t stream) {
  if (T <= 0 || B <= 0 || S < 2 || S > CC_MAX_STATES || nwords != (S + 31) / 32 || L <= 0 ||
      (start == nullptr && (fm == nullptr || min_metric == nullptr)))
    return cudaErrorInvalidValue;
  const int G = (T + L - 1) / L;
  const size_t map_smem = (size_t)L * nwords * kMapFrames * sizeof(unsigned);
  if (G > 65535 || (G > 1 && (map == nullptr || ends == nullptr || map_smem > 48 * 1024)))
    return cudaErrorInvalidValue;
  const dim3 grid((B + kTbThreads - 1) / kTbThreads, G);
  const dim3 map_grid((B + kMapFrames - 1) / kMapFrames, G - 1);
#define CC_LAUNCH_TB(NW_)                                                                 \
  if (G > 1) {                                                                            \
    tb_map_kernel<NW_><<<map_grid, kMapThreads, map_smem, stream>>>(dec, map, T, B, S, L, \
                                                                    G);                   \
    tb_fold_kernel<<<B, kFoldThreads, 0, stream>>>(map, start, fm, ends, min_metric, B,   \
                                                   S, G);                                 \
    stream_traceback_kernel<NW_><<<grid, kTbThreads, 0, stream>>>(                        \
        dec, ends, nullptr, bits, carry, nullptr, T, B, S, K, L);                         \
  } else {                                                                                \
    stream_traceback_kernel<NW_><<<grid, kTbThreads, 0, stream>>>(                        \
        dec, start, fm, bits, carry, min_metric, T, B, S, K, L);                          \
  }
  switch (nwords) {
    case 1: CC_LAUNCH_TB(1); break;
    case 2: CC_LAUNCH_TB(2); break;
    case 4: CC_LAUNCH_TB(4); break;
    case 8: CC_LAUNCH_TB(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef CC_LAUNCH_TB
  return (int)cudaGetLastError();
}

}  // extern "C"
