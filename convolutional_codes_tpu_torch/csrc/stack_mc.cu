// Stack-decoder kernels for Hopper (sm_90a): the Monte-Carlo kernel and the
// decoder of supplied frames, one walk shared by both.
//
// stack_mc_kernel replaces the TPU kernel convolutional_codes_tpu/ops/
// stack_mc.py `_stack_mc_kernel` (:84, entry mc_stack :419).  Frame f of a
// launch (lane f / fpl) has the global id gid = gid0 + f, gid0 = lane0 * fpl,
// so that devices sharing a point decode distinct blocks of one frame-id
// space (the TPU kernel's lane0, stack_mc.py:114-117, :263).  It is made by
// the crew of a warp (sequential.cuh) into the walk's table of branch
// metrics, decoded with the reference's 64-path stack search, and its bit
// errors, frame error and walk iterations are added to the per-lane
// counters [3][lanes] int64 with integer atomics: the sums depend on (seed,
// gid) only, never on the launch geometry nor on the order in which frames
// end.
//
// stack_decode_kernel replaces the TPU kernel ops/stack_pallas.py
// `_stack_kernel` (:86, entry stack_decode_pallas :338).  Each supplied
// frame b of [B][T][M] distances (or [B][T] received symbols), read where
// it lies, runs the same walk and writes the winning path's bits [B][L],
// its metric [B] and the walk's iterations [B].  The TPU entry cut the
// walk into bounded calls with lane compaction on the host (a watchdog of
// that backend); here one launch runs every walk to its end.
//
// The walk is tests/golden_model.py's `_stack_decode` with the JAX kernels'
// choices (stack_mc.py:124-231, stack_pallas.py:113-226): best = first max
// and worst = first min over the live slots (strict compares); the input-1
// duplicate is written before the original takes input 0; at capacity the
// worst slot is replaced, and when it is the best slot itself (all live
// metrics equal) the input-0 write wins.  One iteration is one step of the
// JAX kernels' chained micro-step: accept the next symbol if the best path
// caught up, then extend the best path.
//
// What bounds it on the H100: an iteration is a chain of dependent steps
// (pick best and worst, read the best path's node and branch metrics, write
// two slots), so the card's throughput is the walks in flight over that
// chain's latency, until the pick's instructions fill the issue slots.
// The design:
//  * A persistent grid and a queue of frames, as kernel 8's (fano_mc.cu):
//    SMs x resident blocks; a lane whose walk has ended takes the next
//    frame with an atomicAdd on a counter the caller zeroes, taken one frame
//    ahead so that the atomic's round trip is not waited for.  The warp's
//    loop has no inner loop per frame (a warp would wait there for its
//    slowest lane): each turn is a vote, then kStepsPerVote walk steps.
//    The crew of a warp banks or writes out an ended walk's frame and makes
//    the next one together; in kernel 7, where kSoloRefill lanes or more
//    need a frame at one vote (every lane at the start), each makes its own.
//  * The walk's state on chip.  The 64 path metrics of each resident walk
//    sit in shared memory, laid out [slot][thread] with a stride of
//    blockDim.x (a multiple of 32), so a lane's bank is fixed whatever slot
//    it reads; so do its node words (next-symbol index and encoder state:
//    one word where K - 1 + bits(T) <= 32, else two).  The path bits
//    [word][slot], read and written at two slots an iteration, sit there too
//    where the plan by T leaves room (ops/stack_mc.stack_plan); else in
//    device memory, each slot's words side by side so that a path is one or
//    two sectors, the grid's walks one after another.  A path keeps its L
//    info bits only: the state is in its node word, so the tail's bits are
//    never read.
//  * The pick.  Slots go in 8 groups of 8; each group's first max and
//    first min and their slots are kept in shared memory.  An iteration
//    takes a tree of strict compares, three deep, over the 8 groups' kept
//    values, and rescans the one or two groups it wrote (8 reads issued
//    together, the same tree).  That picks the serial scan's slots, since a
//    later slot or group takes over only where strictly better.  A scan of
//    every live group an iteration was slower on every code (PERF.md).
//  * Branch metrics: kernel 7 reads its walk's table of T * M metrics, made
//    by the crew in device memory; kernel 9 computes them from the supplied
//    frame.  Codes of 5-8 coded bits a symbol run the wide build of this
//    file (stack_mc_wide, sequential.cuh's CC_SEQ_WIDE), whose kernel 7
//    keeps a frame's T received rows instead of a table 8-64 times larger
//    and computes each metric from them (RowMetrics).
// Built with -fmad=false: every product is rounded before its add.
#include "sequential.cuh"

namespace {

constexpr int kDepth = 64;            // paths a walk holds
constexpr int kGroupSlots = 8;        // slots of a group of the pick
constexpr int kGroupCount = kDepth / kGroupSlots;
constexpr int kMaxThreads = 128;      // threads per block of any plan
constexpr int kStepsPerVote = 4;      // walk steps between two refill votes of a warp
// Kernel 7: refills of this many lanes or more at one vote (every lane's at
// the start) run a lane a frame, each lane making its own frame, since the
// crew would make them one after another.
constexpr int kSoloRefill = 16;
// shared words of every walk: its metrics, its groups' max and min, then
// their slots (bytes)
constexpr int kOnChipWords = kDepth + 2 * kGroupCount + 2 * kGroupCount / 4;

// A walk's path bits: word k of slot s's path.  In shared memory (after
// every walk's kOnChipWords and node words) at [k][s][thread], a stride of
// blockDim.x, so a lane's bank is fixed; in device-memory scratch a slot's
// nw words lie side by side, [walk][s][k] (one or two sectors a path), the
// walks of the grid one after another.
struct SharedBits {
  unsigned* base;
  unsigned stride;
  static __device__ __forceinline__ SharedBits make(unsigned*, unsigned lane, int offset, int) {
    extern __shared__ unsigned smem[];
    return {smem + offset * blockDim.x + slot_in_block(lane), blockDim.x};
  }
  __device__ __forceinline__ unsigned& at(int k, int s) const {
    return base[(unsigned)(k * kDepth + s) * stride];
  }
};

struct GlobalBits {
  unsigned* base;
  int nw;
  static __device__ __forceinline__ GlobalBits make(unsigned* scratch, unsigned lane, int,
                                                    int nw) {
    const size_t walk = (size_t)blockIdx.x * blockDim.x + slot_in_block(lane);
    return {scratch + walk * kDepth * nw, nw};
  }
  __device__ __forceinline__ unsigned& at(int k, int s) const { return base[s * nw + k]; }
};

// One walk's 64 slots: in shared memory with a stride of n = blockDim.x,
// the metrics, the groups' kept max and min and their slots (bytes), and
// the node words (kPack: word s is nii << (K-1) | state; else nii is word s
// and the state word 64 + s); the path bits in `Bits`, bit t of slot s at
// bit t & 31 of its word t >> 5.
template <class Bits, bool kPack>
struct Slots {
  static constexpr int kNodeWords = kPack ? kDepth : 2 * kDepth;
  float* met;           // metric of slot s at met[s * n], group g's max at met[(64 + g) * n],
                        // its min at met[(72 + g) * n]
  unsigned char* grp;   // group g's first max's slot at grp[g * n], its first min's at
                        // grp[(8 + g) * n]
  unsigned* nodes;
  unsigned n, top;      // blockDim.x, K - 1
  Bits b;

  static __device__ __forceinline__ Slots make(unsigned* scratch, unsigned lane, int K,
                                               int nw) {
    extern __shared__ unsigned smem[];
    Slots f;
    f.n = blockDim.x;
    f.met = (float*)smem + slot_in_block(lane);
    f.grp = (unsigned char*)(smem + (kDepth + 2 * kGroupCount) * blockDim.x) + slot_in_block(lane);
    f.nodes = smem + kOnChipWords * blockDim.x + slot_in_block(lane);
    f.top = (unsigned)K - 1u;
    f.b = Bits::make(scratch, lane, kOnChipWords + kNodeWords, nw);
    return f;
  }
  __device__ __forceinline__ float& metric(int s) const { return met[(unsigned)s * n]; }
  __device__ __forceinline__ float& gmax(int g) const { return met[(unsigned)(kDepth + g) * n]; }
  __device__ __forceinline__ float& gmin(int g) const {
    return met[(unsigned)(kDepth + kGroupCount + g) * n];
  }
  __device__ __forceinline__ unsigned char& gbest(int g) const { return grp[(unsigned)g * n]; }
  __device__ __forceinline__ unsigned char& gworst(int g) const {
    return grp[(unsigned)(kGroupCount + g) * n];
  }
  __device__ __forceinline__ unsigned& word(int i) const { return nodes[(unsigned)i * n]; }
  __device__ __forceinline__ void node(int s, int* t, unsigned* state) const {
    if constexpr (kPack) {
      const unsigned x = word(s);
      *t = (int)(x >> top);
      *state = x & ((1u << top) - 1u);
    } else {
      *t = (int)word(s);
      *state = word(kDepth + s);
    }
  }
  __device__ __forceinline__ void set_node(int s, int t, unsigned state) const {
    if constexpr (kPack) {
      word(s) = (unsigned)t << top | state;
    } else {
      word(s) = (unsigned)t;
      word(kDepth + s) = state;
    }
  }
  __device__ __forceinline__ unsigned& bits(int k, int s) const { return b.at(k, s); }
  __device__ __forceinline__ unsigned bit(int s, int t) const {
    return bits(t >> 5, s) >> (t & 31) & 1u;
  }
};

// A walk in registers: live slots, symbols received, this iteration's
// best and worst slot (best is the winner once the walk has ended),
// iterations.
struct StackWalk {
  int nstack, widx, best, worst;
  bool done;
  long long iters;
};

// A first max and a first min with their slots.
struct MaxMin {
  float mb, mw;
  int b, c;
};

// a, then b of later slots: b takes over only where strictly better.
__device__ __forceinline__ MaxMin merge(MaxMin a, const MaxMin& b) {
  if (b.mb > a.mb) {
    a.mb = b.mb;
    a.b = b.b;
  }
  if (b.mw < a.mw) {
    a.mw = b.mw;
    a.c = b.c;
  }
  return a;
}

// The first max and first min of 8 values of slots base .. base + 7 (or of
// groups), those at or past `live` out (-inf for the max, +inf for the
// min): a tree of merges, three deep.
__device__ __forceinline__ MaxMin tree8(const float v[kGroupSlots], int base, int live) {
  MaxMin m[kGroupSlots];
  if (base + kGroupSlots <= live) {   // every value in: no masks
#pragma unroll
    for (int k = 0; k < kGroupSlots; ++k) m[k] = {v[k], v[k], base + k, base + k};
  } else {
#pragma unroll
    for (int k = 0; k < kGroupSlots; ++k) {
      const bool in = base + k < live;
      m[k] = {in ? v[k] : -INFINITY, in ? v[k] : INFINITY, base + k, base + k};
    }
  }
#pragma unroll
  for (int step = 1; step < kGroupSlots; step *= 2)
#pragma unroll
    for (int k = 0; k < kGroupSlots; k += 2 * step) m[k] = merge(m[k], m[k + step]);
  return m[0];
}

// The first max and the first min of the live slots in group g (slots 8g
// .. 8g + 7 below nstack): its 8 reads issue together, then tree8.
template <class S>
__device__ __forceinline__ MaxMin group_max_min(const S& f, int g, int nstack) {
  float v[kGroupSlots];
#pragma unroll
  for (int k = 0; k < kGroupSlots; ++k) v[k] = f.metric(g * kGroupSlots + k);
  return tree8(v, g * kGroupSlots, nstack);
}

// The pick of this iteration's best and worst slot: the groups' kept
// maxima and minima, 16 reads together and a tree8 of each, then the
// winning groups' slots.  These are the serial scan's picks: a later slot
// or group takes over only where strictly better.
template <class S>
__device__ __forceinline__ void pick(StackWalk& w, const S& f) {
  float v[kGroupCount], u[kGroupCount];
#pragma unroll
  for (int g = 0; g < kGroupCount; ++g) {
    v[g] = f.gmax(g);
    u[g] = f.gmin(g);
  }
  const int live = (w.nstack + kGroupSlots - 1) / kGroupSlots;   // groups with a live slot
  w.best = f.gbest(tree8(v, 0, live).b);
  w.worst = f.gworst(tree8(u, 0, live).c);
}

// Group g's first max and first min kept again after a write to one of its
// slots.
template <class S>
__device__ __forceinline__ void rescan(const S& f, int g, int nstack) {
  const MaxMin r = group_max_min(f, g, nstack);
  f.gmax(g) = r.mb;
  f.gmin(g) = r.mw;
  f.gbest(g) = (unsigned char)r.b;
  f.gworst(g) = (unsigned char)r.c;
}

template <class S>
__device__ __forceinline__ void stack_start(StackWalk& w, const S& f, int nw) {
  w.nstack = w.widx = 1;
  w.best = w.worst = 0;
  w.done = false;
  w.iters = 0;
  f.set_node(0, 0, 0u);
  f.metric(0) = 0.0f;
  for (int k = 0; k < nw; ++k) f.bits(k, 0) = 0u;
  f.gmax(0) = f.gmin(0) = 0.0f;
  f.gbest(0) = f.gworst(0) = 0;
}

// One iteration of the walk.  The caller runs it as the body of its one
// loop over frames and steps, so that a lane whose walk ends takes its next
// frame without waiting for the rest of its warp.  nw: words of a path's L
// info bits; e_in: the expected symbol of the input bit alone,
// enc.esym(0, 1).
template <class S, class Metrics>
__device__ __forceinline__ void stack_step(StackWalk& w, const S& f, const Metrics& m,
                                           const Encoder& enc, unsigned e_in, int T, int nw) {
  ++w.iters;
  pick(w, f);
  const int best = w.best;
  int t;
  unsigned state;
  f.node(best, &t, &state);
  if (t == w.widx) {      // the best path caught up: accept the next symbol
    if (w.widx == T) {
      w.done = true;
      return;
    }
    ++w.widx;
  }
  const float mb = f.metric(best);
  // true parity is linear: the input-1 symbol is the input-0 one xor e_in
  const unsigned e0 = enc.esym(state, 0u), e1 = enc.qmask ? enc.esym(state, 1u) : e0 ^ e_in;
  const float tm0 = m.at(t, e0), tm1 = m.at(t, e1);
  const bool at_cap = w.nstack >= kDepth;
  const int dup = at_cap ? w.worst : w.nstack;
  if (dup != best) {      // the duplicate takes input 1 (bit t set)
    for (int k = 0; k < nw; ++k)
      f.bits(k, dup) = f.bits(k, best) | (k == (t >> 5) ? 1u << (t & 31) : 0u);
    f.set_node(dup, t + 1, (state | 1u << enc.top) >> 1);
    f.metric(dup) = mb + tm1;
  }
  f.set_node(best, t + 1, state >> 1);   // the original takes input 0 (bit t stays 0)
  f.metric(best) = mb + tm0;
  if (!at_cap) ++w.nstack;
  const int gb = best / kGroupSlots, gd = dup / kGroupSlots;
  rescan(f, gb, w.nstack);
  if (gd != gb) rescan(f, gd, w.nstack);
}

// A lane's next frame: the one it took ahead, and another one ahead from
// the queue while frames are left, so that the atomic's round trip overlaps
// the walk instead of stalling the crew.
__device__ __forceinline__ void take_next(unsigned* queue, unsigned frames, unsigned* f,
                                          unsigned* ahead) {
  *f = *ahead;
  if (*ahead < frames) *ahead = atomicAdd(queue, 1u);
}

// Part `rank` of `n` of the bit errors of frame gid's decoded bits, the
// path of slot `win` of walk `fs`.
template <class S>
__device__ __forceinline__ int frame_errors(const SeqParams& p, const S& fs, int win,
                                            unsigned gid, int rank, int n) {
  int err = 0;
  for (int t = rank; t < p.L; t += n) err += fs.bit(win, t) != frame_bit(p, gid, t);
  return err;
}

// Frame f's bit errors, frame error and walk iterations onto its lane's
// counters [3][lanes].
__device__ __forceinline__ void bank(long long* out, const SeqDecoderParams& p, unsigned f,
                                     int err, long long iters) {
  unsigned long long* row = (unsigned long long*)out + f / (unsigned)p.fpl;
  const size_t lanes = (size_t)p.lanes;
  if (err) {
    atomicAdd(row, (unsigned long long)err);
    atomicAdd(row + lanes, 1ull);
  }
  atomicAdd(row + 2 * lanes, (unsigned long long)iters);
}

// Frames f = 0 .. frames-1 from the queue (gid = gid0 + f, lane = f / fpl), made
// by the crew into the slot's metric table.
template <class Bits, bool kPack>
__global__ void __launch_bounds__(kMaxThreads, 1)
stack_mc_kernel(long long* __restrict__ out, unsigned* __restrict__ queue, unsigned* scratch,
                float* tables, unsigned frames, const __grid_constant__ SeqDecoderParams p,
                unsigned long long* clock) {
  using S = Slots<Bits, kPack>;
  const int T = p.s.T, L = p.s.L, M = p.s.M, nw = (L + 31) / 32;
  Crew c;
  c.lane = threadIdx.x & 31u;
  c.set(0xffffffffu);
  const S f = S::make(scratch, c.lane, p.s.K, nw);
  const Encoder enc = Encoder::make(p.s);
  const unsigned e_in = enc.esym(0u, 1u);
#if CC_SEQ_WIDE
  const RowMetrics m = {&p, reinterpret_cast<const float2*>(slot_table(tables, T, 2, c.lane))};
#else
  const TableMetrics m = {slot_table(tables, T, M, c.lane), (unsigned)M};
#endif
  unsigned fr = frames;                 // the frame being walked; none yet
  unsigned ahead = atomicAdd(queue, 1u);  // the lane's next frame, taken one frame ahead
  StackWalk w;
  w.done = true;
  w.best = 0;
  for (;;) {
    unsigned need = __ballot_sync(c.alive, w.done);
    if (need) __syncwarp(c.alive);   // every lane's slots written so far are visible
    if (__popc(need) >= kSoloRefill) {   // a lane a frame
      bool leave = false;
      if (w.done) {
        if (fr < frames)
          bank(out, p, fr, frame_errors(p.s, f, w.best, p.gid0 + fr, 0, 1), w.iters);
        take_next(queue, frames, &fr, &ahead);
        leave = fr >= frames;
        if (!leave) {
          Crew solo = c;
          solo.rank = 0;
          solo.n = 1;
#if CC_SEQ_WIDE
          crew_gen_wide(p, solo, p.gid0 + fr,
                        reinterpret_cast<float2*>(slot_table(tables, T, 2, c.lane)));
#else
          crew_gen(p, solo, p.gid0 + fr, slot_table(tables, T, M, c.lane));
#endif
          stack_start(w, f, nw);
        }
      }
      c.set(__ballot_sync(c.alive, !leave));
      if (leave) break;
      need = 0u;
    }
    while (need) {
      const unsigned j = __ffs(need) - 1u;
      need &= need - 1u;
      const unsigned fj = __shfl_sync(c.alive, fr, j);
      if (fj < frames) {   // bank lane j's finished frame
        const int win = __shfl_sync(c.alive, w.best, j);
        const int err = __reduce_add_sync(
            c.alive, frame_errors(p.s, S::make(scratch, j, p.s.K, nw), win, p.gid0 + fj,
                                  c.rank, c.n));
        if (c.lane == j) bank(out, p, fj, err, w.iters);
      }
      if (c.lane == j) take_next(queue, frames, &fr, &ahead);
      const unsigned next = __shfl_sync(c.alive, fr, j);
      if (next >= frames) {   // the queue is empty: lane j leaves
        c.set(c.alive & ~(1u << j));
        if (c.lane == j) break;
        continue;
      }
#if CC_SEQ_WIDE
      crew_gen_wide(p, c, p.gid0 + next, reinterpret_cast<float2*>(slot_table(tables, T, 2, j)));
#else
      crew_gen(p, c, p.gid0 + next, slot_table(tables, T, M, j));
#endif
      __syncwarp(c.alive);
      if (c.lane == j) stack_start(w, f, nw);
    }
    if (!(c.alive >> c.lane & 1u)) break;
#pragma unroll 1
    for (int i = 0; i < kStepsPerVote; ++i)
      if (!w.done) stack_step(w, f, m, enc, e_in, T, nw);
  }
  walk_clock_leave(clock);   // the queue was empty: the lane leaves
}

// Supplied frames b = 0 .. p.lanes-1 from the queue: syms [B][T][M]
// float32 or [B][T] int32; the winning path's bits to bits_out [B][L], its
// metric and the walk's iterations to [b] of each.  The crew writes an
// ended walk's bits; the walk computes its metrics from the frame where it
// lies.
template <class Bits, bool kPack>
__global__ void __launch_bounds__(kMaxThreads, 1)
stack_decode_kernel(int* __restrict__ bits_out, float* __restrict__ metric,
                    long long* __restrict__ iters, unsigned* __restrict__ queue,
                    unsigned* scratch, const void* syms,
                    const __grid_constant__ SeqDecoderParams p) {
  using S = Slots<Bits, kPack>;
  const int T = p.s.T, L = p.s.L, M = p.s.M, nw = (L + 31) / 32;
  const unsigned frames = (unsigned)p.lanes;
  const int words = p.s.soft ? T * M : T;
  Crew c;
  c.lane = threadIdx.x & 31u;
  c.set(0xffffffffu);
  const S f = S::make(scratch, c.lane, p.s.K, nw);
  const Encoder enc = Encoder::make(p.s);
  const unsigned e_in = enc.esym(0u, 1u);
  FrameMetrics m = {&p, nullptr};
  unsigned b = frames;                  // the frame being walked; none yet
  unsigned ahead = atomicAdd(queue, 1u);  // the lane's next frame, taken one frame ahead
  StackWalk w;
  w.done = true;
  w.best = 0;
  for (;;) {
    unsigned need = __ballot_sync(c.alive, w.done);
    if (need) __syncwarp(c.alive);   // every lane's slots written so far are visible
    while (need) {
      const unsigned j = __ffs(need) - 1u;
      need &= need - 1u;
      const unsigned bj = __shfl_sync(c.alive, b, j);
      if (bj < frames) {   // write lane j's finished frame
        const S fs = S::make(scratch, j, p.s.K, nw);
        const int win = __shfl_sync(c.alive, w.best, j);
        int* row = bits_out + (size_t)bj * L;
        for (int t = c.rank; t < L; t += c.n) row[t] = (int)fs.bit(win, t);
        if (c.lane == j) {
          metric[bj] = f.metric(w.best);
          iters[bj] = w.iters;
        }
      }
      if (c.lane == j) take_next(queue, frames, &b, &ahead);
      const unsigned next = __shfl_sync(c.alive, b, j);
      if (next >= frames) {   // the queue is empty: lane j leaves
        c.set(c.alive & ~(1u << j));
        if (c.lane == j) break;
        continue;
      }
      __syncwarp(c.alive);   // the crew's reads of lane j's slots come first
      if (c.lane == j) {
        m.fs = (const float*)((const unsigned*)syms + (size_t)next * words);
        stack_start(w, f, nw);
      }
    }
    if (!(c.alive >> c.lane & 1u)) break;
#pragma unroll 1
    for (int i = 0; i < kStepsPerVote; ++i)
      if (!w.done) stack_step(w, f, m, enc, e_in, T, nw);
  }
}

template <bool kMc, class Bits, bool kPack>
const void* instance() {
  if constexpr (kMc)
    return (const void*)stack_mc_kernel<Bits, kPack>;
  else
    return (const void*)stack_decode_kernel<Bits, kPack>;
}

// The kernel of a plan (path bits in shared memory or not, packed node
// words or not), allowed `smem` dynamic shared bytes; null for a plan that
// is refused.
template <bool kMc>
const void* prepare(int shared, int pack, int smem) {
  const void* k[2][2] = {
      {instance<kMc, GlobalBits, false>(), instance<kMc, GlobalBits, true>()},
      {instance<kMc, SharedBits, false>(), instance<kMc, SharedBits, true>()}};
  const void* kernel = k[shared != 0][pack != 0];
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return nullptr;
  return kernel;
}

// A plan the kernels cannot run: a block of other than 1-4 warps, shared
// bytes short of what the plan keeps there, node words that do not pack.
// `shared`: the path bits in shared memory.
bool bad_plan(int K, int L, int T, int shared, int pack, int threads, int blocks, int smem) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || blocks <= 0) return true;
  const long long node = pack ? kDepth : 2 * kDepth, bits = (long long)kDepth * ((L + 31) / 32);
  const long long words = kOnChipWords + node + (shared ? bits : 0);
  if ((long long)smem < 4 * words * threads) return true;
  return pack && (K - 1) + (32 - __builtin_clz((unsigned)T)) > 32;
}

}  // namespace

extern "C" {

// For a launch plan of kernel `mc` (1: stack_mc_kernel, 0:
// stack_decode_kernel) on the current device: info = {resident blocks per
// SM, SMs, registers per thread, local (stack) bytes per thread}.  Returns
// a cudaError_t.
int cc_stack_occupancy(int mc, int shared, int pack, int threads, int smem, int* info) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const void* k = mc ? prepare<true>(shared, pack, smem) : prepare<false>(shared, pack, smem);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  int dev, blocks, sms;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = blocks;
  info[1] = sms;
  info[2] = a.numRegs;
  info[3] = (int)a.localSizeBytes;
  return 0;
}

// Frames of lanes lane0 .. lane0+lanes-1 of a point's frame-id space, banked
// to out's lanes 0 .. lanes-1.
// out [3, lanes] int64, zeroed; queue one uint32, zeroed; scratch: the path
// bits, blocks * threads * 64 * ceil(L / 32) uint32 words, where the plan
// keeps them in device memory (unused when `shared`); tables: blocks *
// threads * T * M float32 (the wide build: T * 2, and dev_points, the
// constellation [M, 2] float32 in device memory, for AWGN; unused by the
// narrow build).  clock: null, or two uint64 words {~0, 0} (sequential.cuh,
// walk_clock_leave).  Host arrays: points [M, 2] float32, polys [symlen]
// uint32.  Returns the launch's cudaError_t.
int cc_mc_stack(long long* out, unsigned* queue, unsigned* scratch, float* tables,
                const float* dev_points, int lanes, int fpl, int lane0, unsigned seed,
                float param, int soft, int snap, int K, int L, int T, int symlen,
                const float* points, const unsigned* polys, unsigned qmask, float inv_nd,
                float weight, int correct, int wrong, int shared, int pack, int threads,
                int blocks, int smem, unsigned long long* clock, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_seq_params(&p.s, seed, param, soft, snap, K, L, T, symlen, points,
                                  polys, qmask, inv_nd);
  if (bad) return bad;
  if (lanes <= 0 || fpl <= 0 || lane0 < 0 || ((long long)lane0 + lanes) * fpl >= (1ll << 31) ||
      bad_plan(K, L, T, shared, pack, threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  p.weight = weight;
  p.correct = correct;
  p.wrong = wrong;
  p.timeout = 0;
  p.lanes = lanes;
  p.fpl = fpl;
  p.gid0 = (unsigned)lane0 * (unsigned)fpl;
#if CC_SEQ_WIDE
  p.points = reinterpret_cast<const float2*>(dev_points);
  if (soft && dev_points == nullptr) return (int)cudaErrorInvalidValue;
#endif
  const void* k = prepare<true>(shared, pack, smem);
  if (!k) return (int)cudaErrorInvalidValue;
  const unsigned frames = (unsigned)lanes * (unsigned)fpl;
  void* args[] = {&out, &queue, &scratch, &tables, (void*)&frames, &p, &clock};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(threads), args, smem, stream);
}

// Decodes `frames` supplied frames: syms [frames][T][M] float32 distances
// (soft) or [frames][T] int32 received symbols; bits [frames][L] int32,
// metric [frames] float32, iters [frames] int64; queue one uint32, zeroed;
// scratch as for cc_mc_stack.  Host array: polys [symlen] uint32.  Returns
// the launch's cudaError_t.
int cc_stack_decode(int* bits, float* metric, long long* iters, unsigned* queue,
                    unsigned* scratch, const void* syms, int frames, int soft, int K, int L,
                    int T, int symlen, const unsigned* polys, unsigned qmask, float weight,
                    int correct, int wrong, int shared, int pack, int threads, int blocks,
                    int smem, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_supplied_params(&p, soft, K, L, T, symlen, polys, qmask, weight,
                                       correct, wrong, 0, frames);
  if (bad) return bad;
  if (bad_plan(K, L, T, shared, pack, threads, blocks, smem)) return (int)cudaErrorInvalidValue;
  const void* k = prepare<false>(shared, pack, smem);
  if (!k) return (int)cudaErrorInvalidValue;
  void* args[] = {&bits, &metric, &iters, &queue, &scratch, (void*)&syms, &p};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(threads), args, smem, stream);
}

}  // extern "C"
