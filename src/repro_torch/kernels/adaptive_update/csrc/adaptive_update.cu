// Hopper (sm_90a) kernels of the adaptive_update family: the MindTheStep
// server update, hand-written in CUDA C++ and bound through a plain C
// interface (ctypes, see ../cuda.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/adaptive_update/:
//   au_fused_tick    <- fused.py:301 fused_tick_call
//                       (_sgd/_momentum/_adam_tick_kernel :234/:244/:256,
//                        _tick_combine :223)
//   au_fused_chain   <- fused.py:137 fused_chain_call
//                       (_sgd/_momentum/_adam_kernel :73/:79/:89, _prefix :66)
//   au_fused_combine <- fused.py:349 fused_combine_call (_combine_kernel :344)
//   au_fused_update  <- kernel.py:46 fused_update_call (_update_kernel :34)
//
// What bounds them: bytes.  Each is an elementwise pass over flat f32 buffers
// of N elements (and, for the tick and the combine, a (K, N) ring), with a
// handful of flops per byte, far below the H100's ~295 flop/byte ridge.  The
// least time is the bytes each must move over 3.35 TB/s.  With a momentum
// body and a K = 8 bf16 ring:
//   tick    p r/w 8N + g 4N + v r/w 8N + ring read 2N per live slot other
//           than the pushed one + slot write 2N   (<= 34N; 32N at the
//           smoke test's taus, which leave 5 live slots besides the push)
//   chain   p r/w 8N + g 4N + v r/w 8N                       = 20N
//   combine g 4N + ring reads (<= 14N) + slot write 2N + g_eff 4N (<= 24N)
//   update  p r/w 8N + g 4N + v r/w 8N                       = 20N
// (adam adds 8N for its second moment).
//
// The tick and the combine, designed from what the tick computes rather
// than from the TPU blocks:
//  * one thread block owns one contiguous range of N; its threads stride
//    through it eight elements at a time, with 16-byte loads and stores
//    (two float4 per f32 buffer, one uint4 per bf16 ring row);
//  * each block folds the per-worker weights onto ring slots itself, from
//    device pointers to step, taus[W] and weights[W], into shared memory:
//    no host sync, nothing precomputed on the host;
//  * the fresh gradient, rounded to the ring's type, takes the place of slot
//    step % K in the combine and is written to that slot, the ONLY slot the
//    kernel writes (the TPU kernel rewrote all K slots of its block, an
//    artefact of its BlockSpec);
//  * the tick reads only live slots: its prologue lists the slots whose
//    folded weight is not 0, in ascending k, and the combine runs over that
//    list, so it moves exactly the bytes above.  A slot no live worker maps
//    to is never read (as in the plain delayed_combine, which gathers only
//    the workers' slots), and for finite ring contents the sum is bitwise
//    the all-slot sum: a skipped term added mul(0, r) = +-0 to an
//    accumulator that starts at +0.  For K <= 8 the list loop is unrolled
//    and every ring load of a unit goes out, predicated on the list's
//    length, before the first multiply-add, together with the p and state
//    loads; a larger K takes a runtime loop over the list.  The first
//    design read all K - 1 other slots, dead or not, in a runtime
//    loop with a branch on the pushed slot: 19.215 ms for the momentum /
//    bf16 tick at N = 1.4388e9 (36N moved at 2.70 TB/s) on an H100 80GB
//    HBM3 at 700 W; this design takes 17.1-17.7 ms there, moving 32N
//    (77-80 % of the byte bound), and the runtime loop in place of the
//    unrolled one 17.25-17.84 ms (PERF.md);
//  * the combine keeps the first design: it still reads every non-pushed
//    slot, one slot a loop iteration.
// The tick and the combine fold same-slot workers before multiplying, so
// they agree with the worker-by-worker plain sum to f32 round-off only.
//
// The chain and fused_apply: one streaming kernel, stream_kernel, over a
// body functor (ChainBody<FAM>, UpdateBody) that streams p, g and 0-2 state
// buffers in place:
//  * a chunk is kThreads x 2 kUnits float4 of each buffer (kUnits = 2 units
//    of 8 elements a thread); thread t takes float4 t, t + kThreads, ..., so
//    every warp access is 512 contiguous bytes; all loads of the chunk go
//    out before the first body, then the bodies, then the stores, with the
//    streaming hints ld/st.global.cs;
//  * one wave of blocks draws chunks from a device counter, so the blocks
//    finish together.  The counter is one u64 per device and stream, kept by
//    the wrapper; it is 0 at every launch, because the block that draws the
//    launch's last index sets it back to 0: no allocation and no memset a
//    call;
//  * with every pointer 16-byte aligned, chunks cover n - n % 4 elements and
//    a scalar tail the last n % 4; otherwise one element a thread, grid
//    stride, over the whole buffer.
// How it was chosen, at N = 1,438,846,976 on an H100 80GB HBM3 at 700 W
// (PERF.md section 6): a profiling build with U in {1, 2, 4}, hints off/on,
// the schedule (one contiguous run of chunks a block; grid stride; the
// counter) and the layout (coalesced as above, or paired: a unit's two
// float4 side by side, the first design's) as template parameters, timed
// against SGD(momentum=0.9, fused=True) at 10.457 ms for the momentum body:
//  * the layout and the schedule decide; U and the hints do not.  Momentum:
//    counter 9.43-9.47 ms at every U (91 % of the byte bound, 0.90x the
//    library), stride 9.80-9.86, ranges 9.84-9.89; paired 9.80-10.51
//    with plain loads and 9.83-15.68 with the hints (an evict-first line
//    can be gone before the thread's second float4 of the same sector);
//  * kept: U = 2, hints on, counter, coalesced: momentum 9.470 ms, update
//    9.425, adam 13.252 (Adam(fused=True) 15.035), sgd 5.588 (SGD 6.418),
//    each within 0.5 % of its body's fastest variant.  The first design
//    (one kernel each; paired float4, one range a block) took 12.82, 12.19,
//    16.20 and 6.48 ms in other calls (chip_smoke.py phase 2).
// Both bodies apply the plain versions' f32 operations one at a time in
// link order (never pre-multiplied), with __fmul_rn/__fadd_rn so nvcc cannot
// contract them into FMAs: the chain and fused_apply are bitwise equal to
// their plain PyTorch versions.  p, the optimizer state and the ring are
// updated in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kThreads = 256;
constexpr int kVec = 8;

enum Family { kSgd = 0, kMomentum = 1, kAdam = 2 };

template <int FAM>
struct NumScalars;
template <>
struct NumScalars<kSgd> {
  static constexpr int value = 4;
};
template <>
struct NumScalars<kMomentum> {
  static constexpr int value = 5;
};
template <>
struct NumScalars<kAdam> {
  static constexpr int value = 11;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ---- loads and stores: 8 consecutive elements, or one ----------------------

__device__ __forceinline__ void load8(const float* ptr, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(ptr)[0];
  const float4 b = reinterpret_cast<const float4*>(ptr)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* ptr, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(ptr)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(ptr)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* ptr, float (&x)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* ptr, const float (&x)[kVec]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(ptr) = raw;
}

__device__ __forceinline__ float load1(const float* ptr) { return *ptr; }
__device__ __forceinline__ float load1(const __nv_bfloat16* ptr) { return __bfloat162float(*ptr); }
__device__ __forceinline__ void store1(float* ptr, float x) { *ptr = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* ptr, float x) { *ptr = __float2bfloat16_rn(x); }

// Round an f32 value to the ring's storage type and back.
__device__ __forceinline__ float to_ring(float x, const float*) { return x; }
__device__ __forceinline__ float to_ring(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- per-block prologue: slot-folded combine weights ------------------------

// w_slot[k] = sum over workers w whose source slot (step - tau_w) mod K is k
// of weights[w] * live[w], in worker order; push = step mod K.  Thread 0.
__device__ __forceinline__ void fold_weights(const int* step, const int* taus,
                                             const float* weights, int W, int K, float* w_slot,
                                             int* push) {
  const int t = *step;
  for (int k = 0; k < K; ++k) w_slot[k] = 0.f;
  for (int w = 0; w < W; ++w) {
    const int tau = taus[w];
    const int src = t - tau;
    const float live = (src >= 0 && tau < K) ? 1.f : 0.f;
    const int slot = ((src % K) + K) % K;
    w_slot[slot] = add(w_slot[slot], mul(weights[w], live));
  }
  *push = ((t % K) + K) % K;
}

__device__ __forceinline__ void fold_slots(const int* step, const int* taus, const float* weights,
                                           int W, int K, float* w_slot, int* push) {
  if (threadIdx.x == 0) fold_weights(step, taus, weights, W, K, w_slot, push);
  __syncthreads();
}

// The tick's prologue: the folded weights, then the slots whose weight is
// not 0, in ascending k (the pushed slot among them, its term the fresh
// gradient): slots[0..count) and their weights.  A slot no live worker maps
// to is never read.
__device__ __forceinline__ void fold_live_slots(const int* step, const int* taus,
                                                const float* weights, int W, int K, float* w_slot,
                                                int* push, int* slots, float* w_live, int* count) {
  if (threadIdx.x == 0) {
    fold_weights(step, taus, weights, W, K, w_slot, push);
    int m = 0;
    for (int k = 0; k < K; ++k) {
      if (w_slot[k] != 0.f) {
        slots[m] = k;
        w_live[m] = w_slot[k];
        ++m;
      }
    }
    *count = m;
  }
  __syncthreads();
}

// ---- the optimizer bodies ---------------------------------------------------

// u: the (combined) gradient.  s: scalar bundle in SCALAR_ORDER.  a/b: the
// family state (momentum: a = v; adam: a = m, b = v).
template <int FAM>
__device__ __forceinline__ void body(float u, const float* s, float& p, float& a, float& b) {
  u = mul(s[0], u);  // scale_by_staleness: f_stale * u
  u = mul(u, s[1]);  // drop_stale: u * f_keep
  u = mul(u, s[2]);  // clip_by_global_norm: u * f_clip
  if (FAM == kSgd) {
    p = add(p, mul(s[3], u));
  } else if (FAM == kMomentum) {
    a = add(mul(s[4], a), mul(s[3], u));  // trace(mu) after scale(-lr)
    p = add(p, a);
  } else {
    const float m = add(mul(s[4], a), mul(s[5], u));
    const float v = add(mul(s[6], b), mul(s[7], mul(u, u)));
    const float out = __fdiv_rn(mul(m, s[9]), add(__fsqrt_rn(mul(v, s[10])), s[8]));
    p = add(p, mul(s[3], out));
    a = m;
    b = v;
  }
}

// Contiguous share of `units` owned by this block.
__device__ __forceinline__ void block_range(long long units, long long& lo, long long& hi) {
  const long long per = (units + gridDim.x - 1) / gridDim.x;
  lo = per * blockIdx.x;
  hi = lo + per < units ? lo + per : units;
}

// ---- fused tick: push + slot-folded combine + scalars + body + apply -------

// 8 ring elements as loaded, before conversion: two float4 or one uint4.
struct Raw8f {
  float4 a, b;
};
template <typename RT>
struct RawOf;
template <>
struct RawOf<float> {
  using type = Raw8f;
};
template <>
struct RawOf<__nv_bfloat16> {
  using type = uint4;
};

__device__ __forceinline__ void load_raw(Raw8f& r, const float* ptr) {
  r.a = reinterpret_cast<const float4*>(ptr)[0];
  r.b = reinterpret_cast<const float4*>(ptr)[1];
}
__device__ __forceinline__ void load_raw(uint4& r, const __nv_bfloat16* ptr) {
  r = *reinterpret_cast<const uint4*>(ptr);
}
__device__ __forceinline__ void unpack8(const Raw8f& r, float (&x)[kVec]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}
__device__ __forceinline__ void unpack8(const uint4& r, float (&x)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

// MAXL > 0: at most MAXL listed slots (K <= MAXL); the loop over them is
// unrolled and every ring load of a unit is issued, predicated on the list's
// length, before the first multiply-add.  MAXL == 0: any K, a runtime loop.
template <int FAM, typename RT, bool VEC, int MAXL>
__global__ void __launch_bounds__(kThreads)
tick_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ s0,
            float* __restrict__ s1, RT* __restrict__ ring, int K, long long n,
            const int* __restrict__ step, const int* __restrict__ taus,
            const float* __restrict__ weights, int W, const float* __restrict__ scalars) {
  __shared__ float w_slot[kMaxK];
  __shared__ float w_live[kMaxK];
  __shared__ int slots[kMaxK];
  __shared__ int push_slot, n_live;
  fold_live_slots(step, taus, weights, W, K, w_slot, &push_slot, slots, w_live, &n_live);
  constexpr int NS = NumScalars<FAM>::value;
  float s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = scalars[i];
  const int push = push_slot, nl = n_live;
  long long lo, hi;
  if (VEC) {
    constexpr int M = MAXL > 0 ? MAXL : 1;
    int lk[M];
    float lw[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      lk[j] = j < nl ? slots[j] : push;
      lw[j] = j < nl ? w_live[j] : 0.f;
    }
    block_range(n / kVec, lo, hi);
    for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) {
      const long long i = u * kVec;
      float gq[kVec], acc[kVec], pv[kVec], av[kVec], bv[kVec];
      load8(g + i, gq);
      if (MAXL > 0) {
        typename RawOf<RT>::type raw[M];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (j < nl && lk[j] != push) load_raw(raw[j], ring + (long long)lk[j] * n + i);
        }
        load8(p + i, pv);
        if (FAM != kSgd) load8(s0 + i, av);
        if (FAM == kAdam) load8(s1 + i, bv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          gq[j] = to_ring(gq[j], ring);
          acc[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < M; ++j) {
          if (j < nl) {
            float r[kVec];
            if (lk[j] == push) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) r[e] = gq[e];
            } else {
              unpack8(raw[j], r);
            }
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[e] = add(acc[e], mul(lw[j], r[e]));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          gq[j] = to_ring(gq[j], ring);
          acc[j] = 0.f;
        }
        for (int j = 0; j < nl; ++j) {
          const int k = slots[j];
          float r[kVec];
          if (k == push) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) r[e] = gq[e];
          } else {
            load8(ring + (long long)k * n + i, r);
          }
          const float wk = w_live[j];
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = add(acc[e], mul(wk, r[e]));
        }
        load8(p + i, pv);
        if (FAM != kSgd) load8(s0 + i, av);
        if (FAM == kAdam) load8(s1 + i, bv);
      }
      store8(ring + (long long)push * n + i, gq);
#pragma unroll
      for (int j = 0; j < kVec; ++j) body<FAM>(acc[j], s, pv[j], av[j], bv[j]);
      store8(p + i, pv);
      if (FAM != kSgd) store8(s0 + i, av);
      if (FAM == kAdam) store8(s1 + i, bv);
    }
  } else {
    block_range(n, lo, hi);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float gq = to_ring(g[i], ring);
      float acc = 0.f;
      for (int j = 0; j < nl; ++j) {
        const int k = slots[j];
        const float r = k == push ? gq : load1(ring + (long long)k * n + i);
        acc = add(acc, mul(w_live[j], r));
      }
      store1(ring + (long long)push * n + i, gq);
      float pv = p[i], av = 0.f, bv = 0.f;
      if (FAM != kSgd) av = s0[i];
      if (FAM == kAdam) bv = s1[i];
      body<FAM>(acc, s, pv, av, bv);
      p[i] = pv;
      if (FAM != kSgd) s0[i] = av;
      if (FAM == kAdam) s1[i] = bv;
    }
  }
}

// ---- combine only: push + slot-folded combine -> g_eff ----------------------

template <typename RT, bool VEC>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ g, RT* __restrict__ ring, float* __restrict__ g_eff,
               int K, long long n, const int* __restrict__ step, const int* __restrict__ taus,
               const float* __restrict__ weights, int W) {
  __shared__ float w_slot[kMaxK];
  __shared__ int push_slot;
  fold_slots(step, taus, weights, W, K, w_slot, &push_slot);
  const int push = push_slot;
  long long lo, hi;
  if (VEC) {
    block_range(n / kVec, lo, hi);
    for (long long u = lo + threadIdx.x; u < hi; u += blockDim.x) {
      const long long i = u * kVec;
      float gq[kVec], acc[kVec];
      load8(g + i, gq);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        gq[j] = to_ring(gq[j], ring);
        acc[j] = 0.f;
      }
      for (int k = 0; k < K; ++k) {
        float r[kVec];
        if (k == push) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) r[j] = gq[j];
        } else {
          load8(ring + (long long)k * n + i, r);
        }
        const float wk = w_slot[k];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = add(acc[j], mul(wk, r[j]));
      }
      store8(ring + (long long)push * n + i, gq);
      store8(g_eff + i, acc);
    }
  } else {
    block_range(n, lo, hi);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const float gq = to_ring(g[i], ring);
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        const float r = k == push ? gq : load1(ring + (long long)k * n + i);
        acc = add(acc, mul(w_slot[k], r));
      }
      store1(ring + (long long)push * n + i, gq);
      g_eff[i] = acc;
    }
  }
}

// ---- the streaming skeleton: fused chain and fused_apply --------------------

// The two bodies the skeleton streams.  Each holds its scalars in registers
// and updates one element: u (the gradient, read only), p, and the state a
// (and b).  kState is the number of state buffers it reads and writes.
template <int FAM>
struct ChainBody {
  static constexpr int kState = FAM == kSgd ? 0 : (FAM == kMomentum ? 1 : 2);
  float s[NumScalars<FAM>::value];
  __device__ explicit ChainBody(const float* scalars) {
#pragma unroll
    for (int i = 0; i < NumScalars<FAM>::value; ++i) s[i] = scalars[i];
  }
  __device__ __forceinline__ void operator()(float u, float& p, float& a, float& b) const {
    body<FAM>(u, s, p, a, b);
  }
};

// fused_apply: v' = mu v - alpha g; p' = p + v'  (scalars: alpha, mu).
struct UpdateBody {
  static constexpr int kState = 1;
  float alpha, mu;
  __device__ explicit UpdateBody(const float* s) : alpha(s[0]), mu(s[1]) {}
  __device__ __forceinline__ void operator()(float g, float& p, float& v, float&) const {
    v = __fsub_rn(mul(mu, v), mul(alpha, g));
    p = add(p, v);
  }
};

template <class Body>
__device__ __forceinline__ void body4(const Body& f, const float4& g, float4& p, float4& a,
                                      float4& b) {
  f(g.x, p.x, a.x, b.x);
  f(g.y, p.y, a.y, b.y);
  f(g.z, p.z, a.z, b.z);
  f(g.w, p.w, a.w, b.w);
}

template <class Body>
__device__ __forceinline__ void stream_one(const Body& f, float* p, const float* g, float* s0,
                                           float* s1, long long i) {
  float pv = p[i], av = 0.f, bv = 0.f;
  if (Body::kState > 0) av = s0[i];
  if (Body::kState > 1) bv = s1[i];
  f(g[i], pv, av, bv);
  p[i] = pv;
  if (Body::kState > 0) s0[i] = av;
  if (Body::kState > 1) s1[i] = bv;
}

constexpr int kUnits = 2;                                  // units of 8 elements a thread
constexpr long long kChunk = (long long)kThreads * 2 * kUnits;  // float4 of each buffer

// One chunk of each buffer.  Thread t takes float4 t, t + kThreads, ..., so
// each warp access is 512 contiguous bytes.  Every load of the chunk goes
// out before the first body, then the bodies, then the stores, all with the
// streaming hint (ld/st.global.cs: evict first, the data is touched once).
// FULL: the whole chunk lies below nq (no predicates).
template <class Body, bool FULL>
__device__ __forceinline__ void stream_chunk(const Body& f, float4* p, const float4* g,
                                             float4* s0, float4* s1, long long q0,
                                             long long nq) {
  constexpr int Q = 2 * kUnits;
  const long long t = q0 + threadIdx.x;
  float4 gv[Q], pv[Q], av[Q], bv[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = t + (long long)j * kThreads;
    if (FULL || q < nq) {
      gv[j] = __ldcs(g + q);
      pv[j] = __ldcs(p + q);
      if (Body::kState > 0) av[j] = __ldcs(s0 + q);
      if (Body::kState > 1) bv[j] = __ldcs(s1 + q);
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const long long q = t + (long long)j * kThreads;
    if (FULL || q < nq) {
      body4(f, gv[j], pv[j], av[j], bv[j]);
      __stcs(p + q, pv[j]);
      if (Body::kState > 0) __stcs(s0 + q, av[j]);
      if (Body::kState > 1) __stcs(s1 + q, bv[j]);
    }
  }
}

// The next chunk for this block from the counter *next.  Every block draws
// until it gets an index >= total, so one launch draws 0 .. total + grid - 1;
// the draw of the last index is the last access of the launch, and it sets
// the counter back to 0 for the next launch on the stream.
__device__ __forceinline__ long long draw(unsigned long long* next, long long total) {
  const unsigned long long c = atomicAdd(next, 1ull);
  if (c == (unsigned long long)(total + gridDim.x - 1)) atomicExch(next, 0ull);
  return (long long)c;
}

// Streams p, g and Body::kState state buffers in place.  VEC (every pointer
// 16-byte aligned): the blocks of one wave draw chunks of float4 over the
// first n - n % 4 elements from *next (0 at the launch), and block 0 takes
// a scalar tail of n % 4; else one element a thread, grid stride.
template <class Body, bool VEC>
__global__ void __launch_bounds__(kThreads)
stream_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ s0,
              float* __restrict__ s1, long long n, const float* __restrict__ scalars,
              unsigned long long* __restrict__ next) {
  const Body f(scalars);
  if (!VEC) {
    const long long step = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += step)
      stream_one(f, p, g, s0, s1, i);
    return;
  }
  const long long nq = n / 4, full = nq / kChunk, total = (nq + kChunk - 1) / kChunk;
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * nq)
    stream_one(f, p, g, s0, s1, 4 * nq + threadIdx.x);
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* a4 = reinterpret_cast<float4*>(s0);
  float4* b4 = reinterpret_cast<float4*>(s1);
  // double-buffered draw: the next chunk's index is fetched while this one runs
  __shared__ long long drawn[2];
  if (threadIdx.x == 0) drawn[0] = draw(next, total);
  __syncthreads();
  for (int k = 0;; k ^= 1) {
    const long long c = drawn[k];
    if (c >= total) break;
    if (threadIdx.x == 0) drawn[k ^ 1] = draw(next, total);
    if (c < full) {
      stream_chunk<Body, true>(f, p4, g4, a4, b4, c * kChunk, nq);
    } else {
      stream_chunk<Body, false>(f, p4, g4, a4, b4, c * kChunk, nq);
    }
    __syncthreads();
  }
}

// One full wave of resident blocks, or `blocks` when that is fewer.
template <typename Kernel>
int wave_for(Kernel kernel, long long blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  long long wave = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks < wave) wave = blocks;
  return wave < 1 ? 1 : (int)wave;
}

// A wave for `units` of work, kThreads a block.
template <typename Kernel>
int grid_for(Kernel kernel, long long units) {
  return wave_for(kernel, (units + kThreads - 1) / kThreads);
}

template <int FAM, typename RT, bool VEC, int MAXL>
int launch_tick(float* p, const float* g, float* s0, float* s1, void* ring, int K, long long n,
                const int* step, const int* taus, const float* weights, int W,
                const float* scalars, cudaStream_t stream) {
  auto kernel = tick_kernel<FAM, RT, VEC, MAXL>;
  const int grid = grid_for(kernel, VEC ? n / kVec : n);
  kernel<<<grid, kThreads, 0, stream>>>(p, g, s0, s1, static_cast<RT*>(ring), K, n, step, taus,
                                        weights, W, scalars);
  return (int)cudaGetLastError();
}

// K <= 8 on the vector path takes the unrolled list loop; else the runtime one
template <int FAM, typename RT>
int dispatch_tick_vec(int vec, float* p, const float* g, float* s0, float* s1,
                      void* ring, int K, long long n, const int* step, const int* taus,
                      const float* weights, int W, const float* scalars, cudaStream_t stream) {
  if (!vec)
    return launch_tick<FAM, RT, false, 0>(p, g, s0, s1, ring, K, n, step, taus, weights, W,
                                          scalars, stream);
  if (K <= 8)
    return launch_tick<FAM, RT, true, 8>(p, g, s0, s1, ring, K, n, step, taus, weights, W,
                                         scalars, stream);
  return launch_tick<FAM, RT, true, 0>(p, g, s0, s1, ring, K, n, step, taus, weights, W, scalars,
                                       stream);
}

template <int FAM>
int dispatch_tick_ring(int ring_bf16, int vec, float* p, const float* g, float* s0,
                       float* s1, void* ring, int K, long long n, const int* step,
                       const int* taus, const float* weights, int W, const float* scalars,
                       cudaStream_t stream) {
  return ring_bf16 ? dispatch_tick_vec<FAM, __nv_bfloat16>(vec, p, g, s0, s1, ring, K, n, step,
                                                           taus, weights, W, scalars, stream)
                   : dispatch_tick_vec<FAM, float>(vec, p, g, s0, s1, ring, K, n, step, taus,
                                                   weights, W, scalars, stream);
}

template <typename RT, bool VEC>
int launch_combine(const float* g, void* ring, float* g_eff, int K, long long n, const int* step,
                   const int* taus, const float* weights, int W, cudaStream_t stream) {
  auto kernel = combine_kernel<RT, VEC>;
  const int grid = grid_for(kernel, VEC ? n / kVec : n);
  kernel<<<grid, kThreads, 0, stream>>>(g, static_cast<RT*>(ring), g_eff, K, n, step, taus,
                                        weights, W);
  return (int)cudaGetLastError();
}

template <class Body, bool VEC>
int launch_stream(float* p, const float* g, float* s0, float* s1, long long n,
                  const float* scalars, unsigned long long* next, cudaStream_t stream) {
  auto kernel = stream_kernel<Body, VEC>;
  const int grid = VEC ? wave_for(kernel, (n / 4 + kChunk - 1) / kChunk) : grid_for(kernel, n);
  kernel<<<grid, kThreads, 0, stream>>>(p, g, s0, s1, n, scalars, next);
  return (int)cudaGetLastError();
}

template <class Body>
int run_stream(int vec, float* p, const float* g, float* s0, float* s1, long long n,
               const float* scalars, unsigned long long* next, cudaStream_t st) {
  return vec ? launch_stream<Body, true>(p, g, s0, s1, n, scalars, next, st)
             : launch_stream<Body, false>(p, g, s0, s1, n, scalars, next, st);
}

}  // namespace

// ---- C interface (ctypes) -----------------------------------------------------
// Every entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).  Invalid arguments are the wrapper's to reject; these only
// refuse an unknown family or a K above kMaxK (cudaErrorInvalidValue = 1).

extern "C" int au_max_k() { return kMaxK; }

extern "C" int au_fused_tick(int family, int ring_bf16, int vec, float* p, const float* g,
                             float* s0, float* s1, void* ring, int K, long long n,
                             const int* step, const int* taus, const float* weights, int W,
                             const float* scalars, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kSgd:
      return dispatch_tick_ring<kSgd>(ring_bf16, vec, p, g, s0, s1, ring, K, n, step, taus,
                                      weights, W, scalars, st);
    case kMomentum:
      return dispatch_tick_ring<kMomentum>(ring_bf16, vec, p, g, s0, s1, ring, K, n, step, taus,
                                           weights, W, scalars, st);
    case kAdam:
      return dispatch_tick_ring<kAdam>(ring_bf16, vec, p, g, s0, s1, ring, K, n, step, taus,
                                       weights, W, scalars, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int au_fused_combine(int ring_bf16, int vec, const float* g, void* ring, float* g_eff,
                                int K, long long n, const int* step, const int* taus,
                                const float* weights, int W, void* stream) {
  if (K < 1 || K > kMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ring_bf16)
    return vec ? launch_combine<__nv_bfloat16, true>(g, ring, g_eff, K, n, step, taus, weights, W, st)
               : launch_combine<__nv_bfloat16, false>(g, ring, g_eff, K, n, step, taus, weights, W, st);
  return vec ? launch_combine<float, true>(g, ring, g_eff, K, n, step, taus, weights, W, st)
             : launch_combine<float, false>(g, ring, g_eff, K, n, step, taus, weights, W, st);
}

// next: the chunk counter, one u64 on the device that is 0 at the call and
// 0 again when the kernel ends.
extern "C" int au_fused_chain(int family, int vec, float* p, const float* g, float* s0,
                              float* s1, long long n, const float* scalars,
                              unsigned long long* next, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (family) {
    case kSgd:
      return run_stream<ChainBody<kSgd>>(vec, p, g, s0, s1, n, scalars, next, st);
    case kMomentum:
      return run_stream<ChainBody<kMomentum>>(vec, p, g, s0, s1, n, scalars, next, st);
    case kAdam:
      return run_stream<ChainBody<kAdam>>(vec, p, g, s0, s1, n, scalars, next, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// scalars: {alpha, mu} on the device.
extern "C" int au_fused_update(int vec, float* p, const float* g, float* v, long long n,
                               const float* scalars, unsigned long long* next, void* stream) {
  return run_stream<UpdateBody>(vec, p, g, v, nullptr, n, scalars, next,
                                static_cast<cudaStream_t>(stream));
}
