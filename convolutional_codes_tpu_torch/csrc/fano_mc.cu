// Fano-decoder kernels for Hopper (sm_90a): the Monte-Carlo kernel and the
// decoder of supplied frames, one serial walk shared by both.
//
// fano_mc_kernel replaces the TPU kernel convolutional_codes_tpu/ops/
// fano_mc.py `_fano_mc_kernel` (:65, entry mc_fano :443).  One thread per
// lane runs frames gid = lane * fpl + k, k = 0 .. fpl-1: it generates each
// frame in the thread (sequential.cuh), decodes it with the reference's
// serial Fano walk, and banks its bit errors and one frame error if any.
// The per-lane counters [3][lanes] int64 (bit errors, frame errors, walk
// iterations) are the only output; the lane is the only coordinate, so the
// counters do not depend on the block size.
//
// fano_decode_kernel replaces the TPU kernel ops/fano_pallas.py
// `_fano_kernel` (:52, entry fano_decode_pallas :313).  One thread per
// supplied frame runs the same walk and writes its decoded bits [L][B] and
// what the JAX entry's diagnostics read at exit (fano_pallas.py:344-356):
// the metric of the node it stopped on, the SEARCH budget left, that
// node's depth, and the walk's iterations, each [B].  The TPU entry cut the
// walk into bounded calls with lane compaction on the host (a watchdog of
// that backend); here one launch runs every walk to its end, so it lasts
// as long as its slowest frame: a timed-out frame walks timeout_per_bit * T
// SEARCH steps.
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
// The TPU kernels ran this as a lockstep machine over [5, T, Bt] / [3, T, Bt]
// node planes with masked reduces; here each lane walks on its own, its node
// arrays in device-memory scratch laid out [field][node][lane].  What bounds
// it on the H100: the latency of one serially dependent node access per
// step and instruction throughput, with warp divergence — a timed-out frame
// walks timeout_per_bit * T steps while its warp-mates finish in about T.
#include "sequential.cuh"

namespace {

constexpr float kDelta = 17.0f;
constexpr int kFields = 8;   // nstate succ0 succ1 | nmetric tm0 tm1 | selected decoded

struct FanoNodes {
  unsigned *nstate, *succ0, *succ1;
  float *nmetric, *tm0, *tm1;
  int *selected, *decoded;
};

// One lane's node arrays in the scratch: node t of a field at [t * S].
__device__ __forceinline__ FanoNodes fano_nodes(int* scratch, int lane, size_t S, int T) {
  const size_t TS = (size_t)T * S;
  int* base = scratch + lane;
  FanoNodes n;
  n.nstate = (unsigned*)base;
  n.succ0 = (unsigned*)(base + TS);
  n.succ1 = (unsigned*)(base + 2 * TS);
  n.nmetric = (float*)(base + 3 * TS);
  n.tm0 = (float*)(base + 4 * TS);
  n.tm1 = (float*)(base + 5 * TS);
  n.selected = base + 6 * TS;
  n.decoded = base + 7 * TS;
  return n;
}

// Where a walk stopped: the node's depth and metric, the SEARCH budget left.
struct FanoExit {
  int depth, timeout_left;
  float metric;
};

// Branch data of node t (state s), sorted best-first.
__device__ __forceinline__ void fano_node(const SeqDecoderParams& p, const FanoNodes& n,
                                          const float* fs, const int* is, size_t S, int t,
                                          unsigned s) {
  unsigned ns0, ns1;
  const unsigned e0 = seq_branch(s, 0u, p.s, &ns0);
  const unsigned e1 = seq_branch(s, 1u, p.s, &ns1);
  const float m0 = seq_metric(p, fs, is, S, t, e0);
  const float m1 = seq_metric(p, fs, is, S, t, e1);
  const bool swap = m0 < m1;
  const size_t i = (size_t)t * S;
  n.succ0[i] = swap ? ns1 : ns0;
  n.succ1[i] = swap ? ns0 : ns1;
  n.tm0[i] = swap ? m1 : m0;
  n.tm1[i] = swap ? m0 : m1;
  n.decoded[i] = swap;
  n.selected[i] = 0;
}

// Decodes the frame in fs/is into n.decoded; adds the walk's iterations and
// returns where it stopped.  A finish or an exhausted budget leaves cur
// where it was, so its node metric is the one written when it was entered.
__device__ FanoExit fano_decode(const SeqDecoderParams& p, const FanoNodes& n,
                                const float* fs, const int* is, size_t S, long long* iters) {
  const int T = p.s.T;
  for (int t = 0; t < T; ++t) {  // nodes beyond the deepest visit decode 0
    n.selected[t * S] = 0;
    n.decoded[t * S] = 0;
  }
  n.nstate[0] = 0u;
  n.nmetric[0] = 0.0f;
  fano_node(p, n, fs, is, S, 0, 0u);
  int cur = 0, timeout = p.timeout;
  float thr = 0.0f;
  bool backtrack = false;
  for (;;) {
    ++*iters;
    if (!backtrack) {      // SEARCH (fano-decoder.c:183-236)
      if (timeout == 0) break;
      --timeout;
      const size_t c = (size_t)cur * S;
      const int sel = n.selected[c];
      const float m_cur = n.nmetric[c];
      const float ms = m_cur + (sel ? n.tm1[c] : n.tm0[c]);
      if (ms >= thr) {
        if (m_cur < thr + kDelta) {   // tighten: closed form of the += DELTA loop
          int k = (int)floorf((ms - thr) / kDelta);
          if (ms >= thr + (float)(k + 1) * kDelta) ++k;
          if (ms < thr + (float)k * kDelta) --k;
          thr = thr + (float)(k > 0 ? k : 0) * kDelta;
        }
        if (cur + 1 == T) break;
        const unsigned next = sel ? n.succ1[c] : n.succ0[c];
        ++cur;
        n.nstate[cur * S] = next;
        n.nmetric[cur * S] = ms;
        fano_node(p, n, fs, is, S, cur, next);
        continue;
      }
      backtrack = true;
    }
    // BACKTRACK (fano-decoder.c:237-264)
    if (cur > 0 && n.nmetric[(cur - 1) * S] >= thr) {
      --cur;
      if (n.selected[cur * S] == 0) {   // take the second branch
        n.selected[cur * S] = 1;
        n.decoded[cur * S] ^= 1;
        backtrack = false;
      }
    } else {                            // relax, retry from the best branch
      thr = thr - kDelta;
      if (n.selected[cur * S] != 0) {
        n.selected[cur * S] = 0;
        n.decoded[cur * S] ^= 1;
      }
      backtrack = false;
    }
  }
  return {cur, timeout, n.nmetric[(size_t)cur * S]};
}

// syms [T][M][lanes] float32 (AWGN) or [T][lanes] int32 (BSC): the datagen
// writes each frame there before the walk reads it.
__global__ void __launch_bounds__(CC_SEQ_THREADS)
fano_mc_kernel(long long* __restrict__ out, int* __restrict__ scratch, void* syms,
               const __grid_constant__ SeqDecoderParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.lanes) return;
  const size_t S = (size_t)p.lanes;
  const FanoNodes n = fano_nodes(scratch, lane, S, p.s.T);
  int* is = (int*)syms + lane;
  float* fs = (float*)syms + lane;
  long long berr = 0, ferr = 0, iters = 0;
  for (int k = 0; k < p.fpl; ++k) {
    const unsigned gid = (unsigned)lane * (unsigned)p.fpl + (unsigned)k;
    gen_frame(p.s, gid, fs, is, S, nullptr);
    fano_decode(p, n, fs, is, S, &iters);
    int err = 0;
    for (int t = 0; t < p.s.L; ++t)
      err += (unsigned)n.decoded[t * S] != frame_bit(p.s, gid, t);
    berr += err;
    ferr += err > 0;
  }
  out[lane] = berr;
  out[S + lane] = ferr;
  out[2 * S + lane] = iters;
}

// Supplied frames, syms laid out as above with lanes = frames: frame b's
// decoded bits to bits_out[t][b]; metric, timeout_left and depth of the node
// where its walk stopped, and its iterations, to [b] of each.
__global__ void __launch_bounds__(CC_SEQ_THREADS)
fano_decode_kernel(int* __restrict__ bits_out, float* __restrict__ metric,
                   int* __restrict__ timeout_left, int* __restrict__ depth,
                   long long* __restrict__ iters, int* __restrict__ scratch,
                   const void* syms, const __grid_constant__ SeqDecoderParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.lanes) return;
  const size_t S = (size_t)p.lanes;
  const FanoNodes n = fano_nodes(scratch, lane, S, p.s.T);
  long long k = 0;
  const FanoExit e = fano_decode(p, n, (const float*)syms + lane, (const int*)syms + lane, S,
                                 &k);
  for (int t = 0; t < p.s.L; ++t) bits_out[(size_t)t * S + lane] = n.decoded[t * S];
  metric[lane] = e.metric;
  timeout_left[lane] = e.timeout_left;
  depth[lane] = e.depth;
  iters[lane] = k;
}

}  // namespace

extern "C" {

// int32 words of scratch either kernel needs for `lanes` lanes.
long long cc_fano_scratch_words(int T, int lanes) {
  return (long long)lanes * T * kFields;
}

// out [3, lanes] int64; scratch of cc_fano_scratch_words int32 words; syms
// as the kernel takes them.  timeout = timeout_per_bit * T SEARCH steps per
// frame.  Host arrays: points [M, 2] float32, polys [symlen] uint32.
// Returns cudaGetLastError().
int cc_mc_fano(long long* out, int* scratch, void* syms, int lanes, int fpl, unsigned seed,
               float param, int soft, int snap, int K, int L, int T, int symlen,
               const float* points, const unsigned* polys, unsigned qmask, float inv_nd,
               float weight, int correct, int wrong, int timeout, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_seq_params(&p.s, seed, param, soft, snap, K, L, T, symlen, points,
                                  polys, qmask, inv_nd);
  if (bad) return bad;
  if (lanes <= 0 || fpl <= 0 || timeout < 0) return (int)cudaErrorInvalidValue;
  p.weight = weight;
  p.correct = correct;
  p.wrong = wrong;
  p.timeout = timeout;
  p.lanes = lanes;
  p.fpl = fpl;
  const dim3 grid((lanes + CC_SEQ_THREADS - 1) / CC_SEQ_THREADS);
  fano_mc_kernel<<<grid, CC_SEQ_THREADS, 0, stream>>>(out, scratch, syms, p);
  return (int)cudaGetLastError();
}

// Decodes `frames` supplied frames: syms [T][M][frames] float32 distances
// (soft) or [T][frames] int32 received symbols; bits [L][frames] int32,
// metric [frames] float32, timeout_left and depth [frames] int32, iters
// [frames] int64; scratch of cc_fano_scratch_words(T, frames) int32 words.
// Host array: polys [symlen] uint32.  Returns cudaGetLastError().
int cc_fano_decode(int* bits, float* metric, int* timeout_left, int* depth, long long* iters,
                   int* scratch, const void* syms, int frames, int soft, int K, int L, int T,
                   int symlen, const unsigned* polys, unsigned qmask, float weight,
                   int correct, int wrong, int timeout, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_supplied_params(&p, soft, K, L, T, symlen, polys, qmask, weight,
                                       correct, wrong, timeout, frames);
  if (bad) return bad;
  const dim3 grid((frames + CC_SEQ_THREADS - 1) / CC_SEQ_THREADS);
  fano_decode_kernel<<<grid, CC_SEQ_THREADS, 0, stream>>>(bits, metric, timeout_left, depth,
                                                          iters, scratch, syms, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
