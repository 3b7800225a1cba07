// Fano-decoder kernels for Hopper (sm_90a): the Monte-Carlo kernel and the
// decoder of supplied frames, one serial walk shared by both.
//
// fano_mc_kernel replaces the TPU kernel convolutional_codes_tpu/ops/
// fano_mc.py `_fano_mc_kernel` (:65, entry mc_fano :443).  Frame
// gid = (lane0 + lane) * fpl + k (k = 0 .. fpl-1; lane0 the launch's first
// global lane, as the TPU kernel's, fano_mc.py:96-101) is generated in the thread
// (sequential.cuh), decoded with the reference's serial Fano walk, and its
// bit errors, frame error and walk iterations are added to the per-lane
// counters [3][lanes] int64.  The sums are of integers, so they do not
// depend on the order of the adds nor on the launch geometry.
//
// fano_decode_kernel replaces the TPU kernel ops/fano_pallas.py
// `_fano_kernel` (:52, entry fano_decode_pallas :313).  Each supplied frame
// b of [B][T][M] distances (or [B][T] received symbols) runs the same walk
// and writes its decoded bits [B][L] and what the JAX entry's diagnostics
// read at exit (fano_pallas.py:344-356): the metric of the node it stopped
// on, the SEARCH budget left, that node's depth, and the walk's iterations.
// The TPU entry cut the walk into bounded calls with lane compaction on the
// host (a watchdog of that backend); here one launch runs every walk to its
// end.
//
// The walk is tests/golden_model.py's `_fano_decode` with the JAX kernels'
// choices (fano_mc.py:153-260, fano_pallas.py:129-230): successors sorted
// best-first with a strict `<` (ties keep input 0); a budget of
// timeout_per_bit * T SEARCH steps per frame, BACKTRACK steps costing none;
// the threshold tightened by the closed form floor((ms - thr) / DELTA) with
// its two corrections (IEEE division; thresholds stay multiples of
// DELTA = 17), relaxed by DELTA; on exhaustion the best-so-far bits, the
// rest 0.  One iteration is one step of the JAX kernels' chained
// micro-step: a SEARCH step, or a BACKTRACK step, or a failed SEARCH step
// together with the first BACKTRACK step after it.  Built with -fmad=false
// and IEEE division: every product is rounded before its add
// (tests/goldens/fano_fma_regression.npz is the guard).
//
// What bounds it on the H100: the walk is a serial chain, one dependent
// step after another, so a frame's time is its iterations times the
// latency of one step, and the card's throughput is the number of walks in
// flight over that latency.  The design attacks both:
//  * The node record.  A node is 16 bytes, {state | selected << 31,
//    nmetric, m0, m1} with m0/m1 the branch metrics by input bit, unsorted,
//    read and written as one uint4 (one 128-bit access).  The sorted
//    order, the decoded bit (swap ^ selected, swap = m0 < m1: the
//    comparison that sorted them), the selected metric m[decoded] and the
//    successor (state | decoded << (K-1)) >> 1 are derived.  The record of
//    the current node lives in registers and in memory alike.
//  * One straight-line iteration.  The walks of a warp are in different
//    phases (SEARCH forward, a failed SEARCH, BACKTRACK back or relax), and a
//    tree of branches would run the union of their paths one after another.
//    fano_step instead issues the same instructions on every lane whatever
//    its phase: both reads at its top (the successor's two branch metrics and
//    the previous node's record), every outcome's values, and one outcome
//    committed by selects, with one store of the record of the node the walk
//    then stands on (memory holds the registers' record, so where nothing
//    changed the store rewrites what is there).  The successor's expected
//    symbols come from the parities of the state's kept bits, computed while
//    the decoded bit is still being compared, so the metric reads wait on
//    that bit alone.  Only the tightening (a SEARCH above the threshold from
//    a node whose metric lies below thr + DELTA) stays a predicated region:
//    it holds the IEEE division, and computed on every lane it made the
//    iteration longer (PERF.md, Findings).
//  * Shared memory.  The records of a frame are laid out [node][slot] with
//    a stride of blockDim.x records (a multiple of 32): a record's bank
//    group (16 bytes, 4 of the 32 banks) is its slot's, mod 8, whatever
//    node it stands on, so the 8 lanes of a quarter warp, which one
//    128-bit access serves together, never conflict.  A frame of T > 454
//    nodes leaves no room for 32 slots in a block; it runs the same walk
//    (fano_step is a template over the storage) on device-memory scratch
//    in the same layout, strided by the grid's slots.
//  * The branch metrics.  Kernel 8's datagen writes each frame's T * M
//    metrics once into a table in device memory, one per slot, so a step
//    reads a metric instead of computing it (staging the table in shared
//    memory would halve the walks an SM holds).  Kernel 10 computes its
//    metrics at each step from the supplied frame where it lies, in its own
//    [B][T][M] layout.  Codes of 5-8 coded bits a symbol run the wide build
//    of this file (fano_mc_wide, sequential.cuh's CC_SEQ_WIDE), whose kernel
//    8 keeps a frame's T received rows instead of a table 8-64 times larger
//    and computes each metric from them (RowMetrics).
//  * A queue of frames.  The grid is persistent (SMs x resident blocks);
//    a lane whose walk has stopped takes the next frame with an atomicAdd
//    on a counter the caller zeroes, so a slow frame no longer idles its
//    warp-mates for the rest of the launch.  The loop has no inner loop per
//    frame (a warp would wait there for its slowest lane): each turn is a
//    vote, then kStepsPerVote walk steps.  The lanes of a warp write out a
//    stopped walk's frame together and, in kernel 8, make its next frame,
//    so that work does not run one lane at a time.  Memory for records and
//    tables scales with resident threads, not with lanes or frames.
#include "sequential.cuh"

namespace {

constexpr float kDelta = 17.0f;
constexpr unsigned kSel = 1u << 31;   // the selected flag in word 0
constexpr int kMaxThreads = 128;      // threads per block of any plan
constexpr int kStepsPerVote = 8;      // walk steps between two refill votes of a warp

// A node's record as one 16-byte word.
__device__ __forceinline__ uint4 record(unsigned w0, float nm, float m0, float m1) {
  return make_uint4(w0, __float_as_uint(nm), __float_as_uint(m0), __float_as_uint(m1));
}

// A slot's node records in shared memory: node t at base[t * blockDim.x],
// base = smem + slot.
struct SharedNodes {
  uint4* base;
  unsigned stride;
  static __device__ __forceinline__ SharedNodes make(unsigned*, unsigned lane) {
    extern __shared__ uint4 smem[];
    return {smem + slot_in_block(lane), blockDim.x};
  }
  __device__ __forceinline__ uint4 load(int t) const { return base[(unsigned)t * stride]; }
  __device__ __forceinline__ void store(int t, uint4 r) const { base[(unsigned)t * stride] = r; }
};

// The same records in device-memory scratch, strided by the grid's slots.
struct GlobalNodes {
  uint4* base;
  size_t stride;
  static __device__ __forceinline__ GlobalNodes make(unsigned* scratch, unsigned lane) {
    const size_t slot = (size_t)blockIdx.x * blockDim.x + slot_in_block(lane);
    return {reinterpret_cast<uint4*>(scratch) + slot, (size_t)gridDim.x * blockDim.x};
  }
  __device__ __forceinline__ uint4 load(int t) const { return base[(size_t)t * stride]; }
  __device__ __forceinline__ void store(int t, uint4 r) const { base[(size_t)t * stride] = r; }
};

// The decoded bit of node t: swap ^ selected, 0 beyond the deepest visit.
template <class Nodes>
__device__ __forceinline__ unsigned node_bit(const Nodes& n, int t, int deepest) {
  if (t > deepest) return 0u;
  const uint4 r = n.load(t);
  return (unsigned)(__uint_as_float(r.z) < __uint_as_float(r.w)) ^ (r.x >> 31);
}

// One frame's walk: the current node's record in registers (w0 = state |
// selected << 31, nmetric, m0, m1), the threshold, the budget left, the
// deepest node visited, the iterations.  `done` once the walk has stopped;
// a finish or an exhausted budget leaves cur where it was, so nm is the
// metric written when cur was entered.
struct Walk {
  unsigned w0;
  float nm, m0, m1, thr;
  int cur, deepest, timeout;
  bool backtrack, done;
  long long iters;
};

template <class Nodes, class Metrics>
__device__ __forceinline__ void fano_start(Walk& w, const Nodes& n, const Metrics& m,
                                           const Encoder& enc, int timeout) {
  w.w0 = 0u;
  w.nm = w.thr = 0.0f;
  w.m0 = m.at(0, enc.esym(0u, 0u));
  w.m1 = m.at(0, enc.esym(0u, 1u));
  n.store(0, record(0u, 0.0f, w.m0, w.m1));
  w.cur = w.deepest = 0;
  w.timeout = timeout;
  w.backtrack = w.done = false;
  w.iters = 0;
}

// The threshold a SEARCH step that moves forward from metric ms tightens
// thr to (the node's metric was below thr + DELTA): the closed form of the
// += DELTA loop.  k0 = floor((ms - thr) / DELTA), then ++k if ms >= thr +
// (k+1) DELTA, then --k if ms < thr + k DELTA: the same operations, the
// three thresholds the two corrections can reach computed side by side.
__device__ __forceinline__ float tighten(float ms, float thr) {
  const int k0 = (int)floorf((ms - thr) / kDelta);
  const float t_lo = thr + (float)(k0 - 1) * kDelta, t_k0 = thr + (float)k0 * kDelta,
              t_hi = thr + (float)(k0 + 1) * kDelta;
  const bool up = ms >= t_hi;
  const bool down = ms < (up ? t_hi : t_k0);
  const int k = k0 + (int)up - (int)down;
  const float t_k = up ? (down ? t_k0 : t_hi) : (down ? t_lo : t_k0);
  return k > 0 ? t_k : thr + (float)0 * kDelta;
}

// The expected symbols e0, e1 of the two branches out of the successor
// s1 | dec << (top - 1) of a state whose kept bits are s1 = state >> 1:
// Encoder::esym's parities with those of s1 apart from the two bits that
// enter them, dec at bit top - 1 and the branch's input at bit top (their
// masks do not change along a walk).  Equal to enc.esym(successor, 0u) and
// enc.esym(successor, 1u), without waiting for dec.
__device__ __forceinline__ void successor_syms(const Encoder& enc, unsigned s1, unsigned dec,
                                               unsigned& e0, unsigned& e1) {
  unsigned ps = 0u, qs = 0u, pd = 0u, qd = 0u, pb = 0u, qb = 0u;
#pragma unroll
  for (int k = 0; k < CC_SEQ_MAX_SYMLEN; ++k) {
    const unsigned r = enc.rpoly[k], rq = r & enc.qmask;
    ps |= (__popc(s1 & r) & 1u) << k;
    qs |= (__popc(s1 & rq) & 1u) << k;
    pd |= (r >> (enc.top - 1u) & 1u) << k;
    qd |= (rq >> (enc.top - 1u) & 1u) << k;
    pb |= (r >> enc.top & 1u) << k;
    qb |= (rq >> enc.top & 1u) << k;
  }
  const unsigned p = dec ? ps ^ pd : ps, q = dec ? qs ^ qd : qs;
  e0 = p & ~q;
  e1 = (p ^ pb) & ~(q ^ qb);
}

// One iteration of the walk (the loop body of fano-decoder.c,
// fano-decoder.c:183-264), a step of a walk that has stopped committing
// nothing.  The caller runs it as the body of its one loop over frames and
// steps, so that a lane whose walk ends takes its next frame without
// waiting for the rest of its warp.  One straight line: every lane reads
// the successor's branch metrics and the previous node's record, computes
// what each outcome needs, and commits its own outcome by selects.
template <class Nodes, class Metrics>
__device__ __forceinline__ void fano_step(Walk& w, const Nodes& n, const Metrics& m,
                                          const Encoder& enc, int T) {
  // both reads first: the successor's branch metrics (a SEARCH that moves
  // forward), the previous node's record (a BACKTRACK)
  const unsigned sel = w.w0 >> 31, s1 = (w.w0 & ~kSel) >> 1;
  const unsigned dec = (unsigned)(w.m0 < w.m1) ^ sel;
  unsigned e0, e1;
  successor_syms(enc, s1, dec, e0, e1);
  const int tn = w.cur + 1 < T ? w.cur + 1 : w.cur;
  const float n0 = m.at(tn, e0), n1 = m.at(tn, e1);
  const int prev = w.cur > 0 ? w.cur - 1 : 0;
  const uint4 p = n.load(prev);
  const float ms = w.nm + (dec ? w.m1 : w.m0), pm = __uint_as_float(p.y);
  // the outcome
  const bool live = !w.done, search = live && !w.backtrack;
  const bool spent = search && w.timeout == 0;         // SEARCH, out of budget: stop
  const bool pass = search && !spent && ms >= w.thr;    // SEARCH above the threshold
  const bool last = pass && w.cur + 1 == T;             // ... at the last node: stop
  const bool fwd = pass && !last;                       // ... move forward
  const bool bt = live && !spent && !pass;              // BACKTRACK, alone or after a failed SEARCH
  const bool back = bt && w.cur > 0 && pm >= w.thr;    // ... move back
  const bool relax = bt && !back;                       // ... relax, retry from the best branch
  float thr = w.thr;
  if (pass && w.nm < thr + kDelta) thr = tighten(ms, thr);
  // commit: moving back takes the previous node's second branch, or goes
  // on backtracking where it was taken; the record of the node the walk
  // then stands on is stored (unchanged where the outcome left it so)
  w.iters += (long long)live;
  w.timeout -= (int)(search && !spent);
  w.done = !live || spent || last;
  w.thr = relax ? thr - kDelta : thr;
  // word 0 by masks: the successor, the previous node's with its second
  // branch taken, or this node's (its selected flag cleared by a relax)
  const unsigned to_fwd = 0u - (unsigned)fwd, to_back = 0u - (unsigned)back;
  w.w0 = ((s1 | dec << (enc.top - 1u)) & to_fwd) | ((p.x | kSel) & to_back) |
         ((relax ? w.w0 & ~kSel : w.w0) & ~(to_fwd | to_back));
  w.nm = fwd ? ms : back ? pm : w.nm;
  w.m0 = fwd ? n0 : back ? __uint_as_float(p.z) : w.m0;
  w.m1 = fwd ? n1 : back ? __uint_as_float(p.w) : w.m1;
  w.cur = fwd ? w.cur + 1 : back ? prev : w.cur;
  w.deepest = w.cur > w.deepest ? w.cur : w.deepest;
  w.backtrack = back && (p.x & kSel) != 0u;
  n.store(w.cur, record(w.w0, w.nm, w.m0, w.m1));
}

// Frames f = 0 .. frames-1 from the queue (gid = gid0 + f, lane = f / fpl),
// generated by the crew into the slot's metric table.
template <class Nodes>
__global__ void __launch_bounds__(kMaxThreads, 1)
fano_mc_kernel(long long* __restrict__ out, unsigned* __restrict__ queue, unsigned* nodes,
               float* tables, unsigned frames, const __grid_constant__ SeqDecoderParams p,
               unsigned long long* clock) {
  const int T = p.s.T, L = p.s.L, M = p.s.M;
  Crew c;
  c.lane = threadIdx.x & 31u;
  c.set(0xffffffffu);
  const Nodes n = Nodes::make(nodes, c.lane);
  const Encoder enc = Encoder::make(p.s);
#if CC_SEQ_WIDE
  const RowMetrics m = {&p, reinterpret_cast<const float2*>(slot_table(tables, T, 2, c.lane))};
#else
  const TableMetrics m = {slot_table(tables, T, M, c.lane), (unsigned)M};
#endif
  const size_t lanes = (size_t)p.lanes;
  unsigned f = frames;   // the frame being walked; none yet
  Walk w;
  w.done = true;
  for (;;) {
    unsigned need = __ballot_sync(c.alive, w.done);
    if (need) __syncwarp(c.alive);   // every lane's records written so far are visible
    while (need) {
      const unsigned j = __ffs(need) - 1u;
      need &= need - 1u;
      const unsigned fj = __shfl_sync(c.alive, f, j);
      if (fj < frames) {   // bank lane j's finished frame
        const Nodes nj = Nodes::make(nodes, j);
        const int deepest = __shfl_sync(c.alive, w.deepest, j);
        int err = 0;
        for (int t = c.rank; t < L; t += c.n)
          err += node_bit(nj, t, deepest) != frame_bit(p.s, p.gid0 + fj, t);
        err = __reduce_add_sync(c.alive, err);
        if (c.lane == j) {
          unsigned long long* row = (unsigned long long*)out + fj / (unsigned)p.fpl;
          if (err) {
            atomicAdd(row, (unsigned long long)err);
            atomicAdd(row + lanes, 1ull);
          }
          atomicAdd(row + 2 * lanes, (unsigned long long)w.iters);
          f = atomicAdd(queue, 1u);
        }
      } else if (c.lane == j) {
        f = atomicAdd(queue, 1u);
      }
      const unsigned next = __shfl_sync(c.alive, f, j);
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
      if (c.lane == j) fano_start(w, n, m, enc, p.timeout);
    }
    if (!(c.alive >> c.lane & 1u)) break;
#pragma unroll 1
    for (int i = 0; i < kStepsPerVote; ++i)
      fano_step(w, n, m, enc, T);
  }
  walk_clock_leave(clock);   // the queue was empty: the lane leaves
}

// Supplied frames b = 0 .. p.lanes-1 from the queue: syms [B][T][M]
// float32 or [B][T] int32; bits_out [B][L]; metric, timeout_left and depth
// of the node where the walk stopped, and its iterations, to [b] of each.
// The crew writes a finished frame's bits; the walk computes its metrics
// from the frame where it lies.
template <class Nodes>
__global__ void __launch_bounds__(kMaxThreads, 1)
fano_decode_kernel(int* __restrict__ bits_out, float* __restrict__ metric,
                   int* __restrict__ timeout_left, int* __restrict__ depth,
                   long long* __restrict__ iters, unsigned* __restrict__ queue, unsigned* nodes,
                   const void* syms, const __grid_constant__ SeqDecoderParams p) {
  const int T = p.s.T, L = p.s.L, M = p.s.M;
  const unsigned frames = (unsigned)p.lanes;
  const int words = p.s.soft ? T * M : T;
  Crew c;
  c.lane = threadIdx.x & 31u;
  c.set(0xffffffffu);
  const Nodes n = Nodes::make(nodes, c.lane);
  const Encoder enc = Encoder::make(p.s);
  FrameMetrics m = {&p, nullptr};
  unsigned b = frames;   // the frame being walked; none yet
  Walk w;
  w.done = true;
  for (;;) {
    unsigned need = __ballot_sync(c.alive, w.done);
    if (need) __syncwarp(c.alive);   // every lane's records written so far are visible
    while (need) {
      const unsigned j = __ffs(need) - 1u;
      need &= need - 1u;
      const unsigned bj = __shfl_sync(c.alive, b, j);
      if (bj < frames) {   // write lane j's finished frame
        const Nodes nj = Nodes::make(nodes, j);
        const int deepest = __shfl_sync(c.alive, w.deepest, j);
        int* row = bits_out + (size_t)bj * L;
        for (int t = c.rank; t < L; t += c.n) row[t] = (int)node_bit(nj, t, deepest);
        if (c.lane == j) {
          metric[bj] = w.nm;
          timeout_left[bj] = w.timeout;
          depth[bj] = w.cur;
          iters[bj] = w.iters;
        }
      }
      if (c.lane == j) b = atomicAdd(queue, 1u);
      const unsigned next = __shfl_sync(c.alive, b, j);
      if (next >= frames) {   // the queue is empty: lane j leaves
        c.set(c.alive & ~(1u << j));
        if (c.lane == j) break;
        continue;
      }
      __syncwarp(c.alive);   // the crew's reads of lane j's records come first
      if (c.lane == j) {
        m.fs = (const float*)((const unsigned*)syms + (size_t)next * words);
        fano_start(w, n, m, enc, p.timeout);
      }
    }
    if (!(c.alive >> c.lane & 1u)) break;
#pragma unroll 1
    for (int i = 0; i < kStepsPerVote; ++i)
      fano_step(w, n, m, enc, T);
  }
}

// The kernel of a plan (node records in shared memory or not), allowed
// `smem` dynamic shared bytes; null for a plan that is refused.
template <bool kMc>
const void* prepare(int shared, int smem) {
  const void* k;
  if constexpr (kMc)
    k = shared ? (const void*)fano_mc_kernel<SharedNodes>
               : (const void*)fano_mc_kernel<GlobalNodes>;
  else
    k = shared ? (const void*)fano_decode_kernel<SharedNodes>
               : (const void*)fano_decode_kernel<GlobalNodes>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return nullptr;
  return k;
}

bool bad_geometry(int threads, int blocks, int smem) {
  return threads < 32 || threads > kMaxThreads || threads % 32 || blocks <= 0 || smem < 0;
}

}  // namespace

extern "C" {

// For a launch plan of kernel `mc` (1: fano_mc_kernel, 0:
// fano_decode_kernel) on the current device, node records in shared memory
// or not (`shared`): info = {resident blocks per SM, SMs, registers per
// thread, local (stack) bytes per thread}.  Returns a cudaError_t.
int cc_fano_occupancy(int mc, int shared, int threads, int smem, int* info) {
  if (bad_geometry(threads, 1, smem)) return (int)cudaErrorInvalidValue;
  const void* k = mc ? prepare<true>(shared, smem) : prepare<false>(shared, smem);
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
// out [3, lanes] int64, zeroed; queue one uint32, zeroed; nodes: blocks *
// threads * 4 * T uint32 words (unused when `shared`); tables: blocks *
// threads * T * M float32 (the wide build: T * 2, and dev_points, the
// constellation [M, 2] float32 in device memory, for AWGN; unused by the
// narrow build).  timeout = timeout_per_bit * T SEARCH steps per frame.
// clock: null, or two uint64 words {~0, 0} (sequential.cuh, walk_clock_leave).
// Host arrays: points [M, 2] float32, polys [symlen] uint32.  Returns the
// launch's cudaError_t.
int cc_mc_fano(long long* out, unsigned* queue, unsigned* nodes, float* tables,
               const float* dev_points, int lanes, int fpl, int lane0, unsigned seed,
               float param, int soft, int snap, int K, int L, int T, int symlen,
               const float* points, const unsigned* polys, unsigned qmask, float inv_nd,
               float weight, int correct, int wrong, int timeout, int shared, int threads,
               int blocks, int smem, unsigned long long* clock, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_seq_params(&p.s, seed, param, soft, snap, K, L, T, symlen, points,
                                  polys, qmask, inv_nd);
  if (bad) return bad;
  if (lanes <= 0 || fpl <= 0 || lane0 < 0 || ((long long)lane0 + lanes) * fpl >= (1ll << 31) ||
      timeout < 0 ||
      bad_geometry(threads, blocks, smem))
    return (int)cudaErrorInvalidValue;
  p.weight = weight;
  p.correct = correct;
  p.wrong = wrong;
  p.timeout = timeout;
  p.lanes = lanes;
  p.fpl = fpl;
  p.gid0 = (unsigned)lane0 * (unsigned)fpl;
#if CC_SEQ_WIDE
  p.points = reinterpret_cast<const float2*>(dev_points);
  if (soft && dev_points == nullptr) return (int)cudaErrorInvalidValue;
#endif
  const void* k = prepare<true>(shared, smem);
  if (!k) return (int)cudaErrorInvalidValue;
  const unsigned frames = (unsigned)lanes * (unsigned)fpl;
  void* args[] = {&out, &queue, &nodes, &tables, (void*)&frames, &p, &clock};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(threads), args, smem, stream);
}

// Decodes `frames` supplied frames: syms [frames][T][M] float32 distances
// (soft) or [frames][T] int32 received symbols; bits [frames][L] int32,
// metric [frames] float32, timeout_left and depth [frames] int32, iters
// [frames] int64; queue one uint32, zeroed; nodes as for cc_mc_fano.
// Host array: polys [symlen] uint32.  Returns the launch's cudaError_t.
int cc_fano_decode(int* bits, float* metric, int* timeout_left, int* depth, long long* iters,
                   unsigned* queue, unsigned* nodes, const void* syms, int frames, int soft,
                   int K, int L, int T, int symlen, const unsigned* polys, unsigned qmask,
                   float weight, int correct, int wrong, int timeout, int shared, int threads,
                   int blocks, int smem, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_supplied_params(&p, soft, K, L, T, symlen, polys, qmask, weight,
                                       correct, wrong, timeout, frames);
  if (bad) return bad;
  if (bad_geometry(threads, blocks, smem)) return (int)cudaErrorInvalidValue;
  const void* k = prepare<false>(shared, smem);
  if (!k) return (int)cudaErrorInvalidValue;
  void* args[] = {&bits, &metric, &timeout_left, &depth, &iters, &queue, &nodes, (void*)&syms,
                  &p};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(threads), args, smem, stream);
}

}  // extern "C"
