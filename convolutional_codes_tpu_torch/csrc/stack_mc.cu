// Stack-decoder kernels for Hopper (sm_90a): the Monte-Carlo kernel and the
// decoder of supplied frames, one serial walk shared by both.
//
// stack_mc_kernel replaces the TPU kernel convolutional_codes_tpu/ops/
// stack_mc.py `_stack_mc_kernel` (:84, entry mc_stack :419).  One thread
// per lane runs frames gid = lane * fpl + k, k = 0 .. fpl-1: it generates
// each frame in the thread (sequential.cuh), decodes it with the
// reference's serial 64-path stack search, and banks its bit errors and one
// frame error if any.  The per-lane counters [3][lanes] int64 (bit errors,
// frame errors, walk iterations) are the only output; the lane is the only
// coordinate, so the counters do not depend on the block size.
//
// stack_decode_kernel replaces the TPU kernel ops/stack_pallas.py
// `_stack_kernel` (:86, entry stack_decode_pallas :338).  One thread per
// supplied frame runs the same walk and writes the winning path's bits
// [L][B], its metric [B] and the walk's iterations [B].  The TPU entry cut
// the walk into bounded calls with lane compaction on the host (a watchdog
// of that backend); here one launch runs every walk to its end, so it
// lasts as long as its slowest frame.
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
// The TPU kernels ran this as a lockstep machine over [64, Bt] planes with
// masked reduces; here each lane walks on its own.  Per-lane state lives in
// device-memory scratch laid out [field][index][lane], so the 64-slot
// scans of a warp read neighbouring addresses.  What bounds it on the H100:
// instruction throughput and the latency of those scans — every iteration
// reads the 64 live metrics — with warp divergence, since the lanes of a
// warp walk for different numbers of iterations.
#include "sequential.cuh"

namespace {

constexpr int kDepth = 64;

__device__ __forceinline__ int stack_nwords(int T) { return (T + 31) / 32; }

// One lane's walk state in the scratch: slot s of a field at [s * S], word
// w of slot s's path bits at [(w * 64 + s) * S].
struct StackState {
  int* nii;
  unsigned* st;
  float* met;
  unsigned* bits;
};

__device__ __forceinline__ StackState stack_state(int* scratch, int lane, size_t S) {
  StackState w;
  w.nii = scratch + lane;
  w.st = (unsigned*)(w.nii + kDepth * S);
  w.met = (float*)(w.st + kDepth * S);
  w.bits = (unsigned*)(w.met + kDepth * S);
  return w;
}

// Bit t of slot `slot`'s path.
__device__ __forceinline__ unsigned path_bit(const StackState& w, size_t S, int slot, int t) {
  return (w.bits[((size_t)(t >> 5) * kDepth + slot) * S] >> (t & 31)) & 1u;
}

// Decodes the frame in fs/is; returns the winning slot, adds the walk's
// iterations to *iters.  Element (field row r) of this lane is at [r * S].
// Kept out of line: inlined into the kernel, nvcc 12.9 at -O3 produced a
// walk that ended after a handful of iterations (widx jumped to T), which
// the exact checks against the plain version caught; the out-of-line form
// decodes every golden bit for bit.
__device__ __noinline__ int stack_decode(const SeqDecoderParams& p, int* nii, unsigned* st, float* met,
                            unsigned* bits, const float* fs, const int* is, size_t S,
                            long long* iters) {
  const int T = p.s.T, nw = stack_nwords(T);
  int nstack = 1, widx = 1, best = 0;
  nii[0] = 0;
  st[0] = 0u;
  met[0] = 0.0f;
  for (int w = 0; w < nw; ++w) bits[(size_t)w * kDepth * S] = 0u;
  for (;;) {
    ++*iters;
    best = 0;
    int worst = 0;
    float mb = met[0], mw = mb;
    for (int s = 1; s < nstack; ++s) {
      const float v = met[s * S];
      if (v > mb) {
        mb = v;
        best = s;
      }
      if (v < mw) {
        mw = v;
        worst = s;
      }
    }
    const int t = nii[best * S];
    if (t == widx) {      // the best path caught up: accept the next symbol
      if (widx == T) break;
      ++widx;
    }
    const unsigned s0 = st[best * S];
    const float m = met[best * S];
    unsigned ns0, ns1;
    const unsigned e0 = seq_branch(s0, 0u, p.s, &ns0);
    const unsigned e1 = seq_branch(s0, 1u, p.s, &ns1);
    const float tm0 = seq_metric(p, fs, is, S, t, e0);
    const float tm1 = seq_metric(p, fs, is, S, t, e1);
    const bool at_cap = nstack >= kDepth;
    const int dup = at_cap ? worst : nstack;
    if (dup != best) {    // the duplicate takes input 1 (bit t set)
      for (int w = 0; w < nw; ++w) {
        const unsigned set = w == (t >> 5) ? 1u << (t & 31) : 0u;
        bits[((size_t)w * kDepth + dup) * S] = bits[((size_t)w * kDepth + best) * S] | set;
      }
      nii[dup * S] = t + 1;
      st[dup * S] = ns1;
      met[dup * S] = m + tm1;
    }
    nii[best * S] = t + 1;  // the original takes input 0 (bit t stays 0)
    st[best * S] = ns0;
    met[best * S] = m + tm0;
    if (!at_cap) ++nstack;
  }
  return best;
}

// syms [T][M][lanes] float32 (AWGN) or [T][lanes] int32 (BSC): the datagen
// writes each frame there before the walk reads it.
__global__ void __launch_bounds__(CC_SEQ_THREADS)
stack_mc_kernel(long long* __restrict__ out, int* __restrict__ scratch, void* syms,
                const __grid_constant__ SeqDecoderParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.lanes) return;
  const size_t S = (size_t)p.lanes;
  const StackState w = stack_state(scratch, lane, S);
  int* is = (int*)syms + lane;
  float* fs = (float*)syms + lane;
  long long berr = 0, ferr = 0, iters = 0;
  for (int k = 0; k < p.fpl; ++k) {
    const unsigned gid = (unsigned)lane * (unsigned)p.fpl + (unsigned)k;
    gen_frame(p.s, gid, fs, is, S, nullptr);
    const int win = stack_decode(p, w.nii, w.st, w.met, w.bits, fs, is, S, &iters);
    int err = 0;
    for (int t = 0; t < p.s.L; ++t) err += path_bit(w, S, win, t) != frame_bit(p.s, gid, t);
    berr += err;
    ferr += err > 0;
  }
  out[lane] = berr;
  out[S + lane] = ferr;
  out[2 * S + lane] = iters;
}

// Supplied frames, syms laid out as above with lanes = frames: frame b's
// decoded bits to bits_out[t][b], winning metric to metric[b], iterations
// to iters[b].
__global__ void __launch_bounds__(CC_SEQ_THREADS)
stack_decode_kernel(int* __restrict__ bits_out, float* __restrict__ metric,
                    long long* __restrict__ iters, int* __restrict__ scratch,
                    const void* syms, const __grid_constant__ SeqDecoderParams p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.lanes) return;
  const size_t S = (size_t)p.lanes;
  const StackState w = stack_state(scratch, lane, S);
  long long n = 0;
  const int win = stack_decode(p, w.nii, w.st, w.met, w.bits, (const float*)syms + lane,
                               (const int*)syms + lane, S, &n);
  for (int t = 0; t < p.s.L; ++t) bits_out[(size_t)t * S + lane] = (int)path_bit(w, S, win, t);
  metric[lane] = w.met[win * S];
  iters[lane] = n;
}

}  // namespace

extern "C" {

// int32 words of scratch either kernel needs for `lanes` lanes.
long long cc_stack_scratch_words(int T, int lanes) {
  return (long long)lanes * kDepth * (3 + (T + 31) / 32);
}

// out [3, lanes] int64; scratch of cc_stack_scratch_words int32 words; syms
// as the kernel takes them.  Host arrays: points [M, 2] float32, polys
// [symlen] uint32.  Returns cudaGetLastError().
int cc_mc_stack(long long* out, int* scratch, void* syms, int lanes, int fpl, unsigned seed,
                float param, int soft, int snap, int K, int L, int T, int symlen,
                const float* points, const unsigned* polys, unsigned qmask, float inv_nd,
                float weight, int correct, int wrong, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_seq_params(&p.s, seed, param, soft, snap, K, L, T, symlen, points,
                                  polys, qmask, inv_nd);
  if (bad) return bad;
  if (lanes <= 0 || fpl <= 0) return (int)cudaErrorInvalidValue;
  p.weight = weight;
  p.correct = correct;
  p.wrong = wrong;
  p.timeout = 0;
  p.lanes = lanes;
  p.fpl = fpl;
  const dim3 grid((lanes + CC_SEQ_THREADS - 1) / CC_SEQ_THREADS);
  stack_mc_kernel<<<grid, CC_SEQ_THREADS, 0, stream>>>(out, scratch, syms, p);
  return (int)cudaGetLastError();
}

// Decodes `frames` supplied frames: syms [T][M][frames] float32 distances
// (soft) or [T][frames] int32 received symbols; bits [L][frames] int32,
// metric [frames] float32, iters [frames] int64; scratch of
// cc_stack_scratch_words(T, frames) int32 words.  Host array: polys [symlen]
// uint32.  Returns cudaGetLastError().
int cc_stack_decode(int* bits, float* metric, long long* iters, int* scratch,
                    const void* syms, int frames, int soft, int K, int L, int T, int symlen,
                    const unsigned* polys, unsigned qmask, float weight, int correct,
                    int wrong, cudaStream_t stream) {
  SeqDecoderParams p;
  const int bad = fill_supplied_params(&p, soft, K, L, T, symlen, polys, qmask, weight,
                                       correct, wrong, 0, frames);
  if (bad) return bad;
  const dim3 grid((frames + CC_SEQ_THREADS - 1) / CC_SEQ_THREADS);
  stack_decode_kernel<<<grid, CC_SEQ_THREADS, 0, stream>>>(bits, metric, iters, scratch,
                                                           syms, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
