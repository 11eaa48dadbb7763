// Hopper (sm_90a) Mamba-1 selective scan, hand-written in CUDA C++ and bound
// through a plain C interface (ctypes, see ../cuda.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan/kernel.py:57
// selective_scan_call (_scan_kernel :34):
//
//   h_t[d, n] = exp(delta_t[d] A[d, n]) h_{t-1}[d, n] + delta_t[d] B_t[n] u_t[d]
//   y_t[d]    = sum_n h_t[d, n] C_t[n]
//
// from h_0 = 0, with u (B, S, D) in bf16 or f32 (cast to f32 here, as the TPU
// kernel does), delta (B, S, D), A (D, N), B and C (B, S, N) f32; y (B, S, D)
// f32.  It also writes the final state hT (B, D, N) f32, which y does not
// determine and the decode cache needs, so the prefill runs one scan.  d_skip
// and the silu(z) gate stay outside, as in the reference.
//
// What bounds it: operations.  Each (b, t, d, n) costs an exponential, which
// runs on the SFU at 16 a clock per SM, plus about six f32 operations; each
// (b, t, d) moves only 10-12 bytes.  At B 4, S 4096, D 8192, N 16 that is
// 2.15e9 exponentials (0.51 ms at 132 SMs and 1.98 GHz) against 1.35 GB
// (0.40 ms at 3.35 TB/s).
//
// The first design gave one thread one (b, d) channel for all S
// steps: a grid of (D/128, B) blocks of 4 warps, at most 8 warps an SM, each
// step's y a 16-long chain of dependent FMAs, and an accurate expf (range
// reduction around the SFU op, ~9 instructions) per (t, n).  Removing its
// loads and stores did not make it faster: its instruction schedule bound
// it.  At the falcon-mamba shape it took 2.132 ms with u in bf16 and 1.488
// ms with u in f32 (H100 80GB HBM3, 700 W; PERF.md).
//
// This design makes time parallel inside a block and computes each
// exponential exactly once:
//  * a block owns kCh = 64 channels of one batch row and walks the sequence
//    in chunks of kT = 32 steps; each channel's chunk is cut into kSeg = 2
//    segments of kL = 16 steps, one thread each.  A warp holds 16
//    neighbouring channels x 2 segments (lane = segment * 16 + channel), so
//    a channel's segments sit in one warp and a row of y covers 64 bytes;
//  * per chunk the state loop n is outermost.  For each n a thread forms its
//    16 doubled decays 2 a_t (see below) and b_t = (dt_t u_t) B_t[n]
//    (dt_t u_t once per step, not per n), keeps them in registers and folds
//    them as a tree into one pair; the channel's 2 pairs are scanned with
//    the associative (a, b) o (a', b') = (a a', a' b + b') by one warp
//    shuffle, seeded with the state carried from the previous chunk; then
//    each thread walks its steps again from its exclusive prefix, h_t = a_t
//    h_{t-1} + b_t, and sums y_t += h_t C_t[n] in 16 registers that are
//    independent across steps (no dependent chain over n).  The last
//    segment's state is the carry (shared memory) and, after the last chunk,
//    hT;
//  * exponentials: 2 a_t = ex2.approx.ftz(dt A log2 e + 1), one FFMA and one
//    SFU op per (t, n), A pre-scaled once per block.  Unshifted, ex2.approx
//    (or __expf) of an argument just below 0 errs enough, relative to
//    1 - a, that decays near 1 miss the 3e-5 gate at the falcon-mamba shape
//    with random A (143-145 of 134M y values); shifted by one, as expf's own
//    range reduction does, it holds.  The factor 2 is never multiplied out:
//    the walk runs on g_j = 2^j h_j (g_j = 2 a_j g_{j-1} + 2^j b_j, with
//    the 2^j folded into dt u once per chunk and out of y once per chunk),
//    and the scan and carry hold h / 2; all exact powers of two;
//  * B_t and C_t are the same for every channel of a batch row: each chunk's
//    (kT, N) rows are staged once per block in shared memory by cp.async,
//    double-buffered, transposed to [n][t] with 16-byte rows (read as
//    float4), and delta and u are staged the same way a chunk ahead, 16
//    bytes a copy, into [t][channel] tiles whose 16-channel groups are
//    XOR-swizzled by segment against bank conflicts;
//  * 128 threads a block at 128 registers (ptxas: 120-160 bytes of spill,
//    outside the state loop), so 4 blocks (16 warps) share an SM; the grid
//    of 128 x 4 blocks at the falcon-mamba shape is one wave.
// What bounds it: the issue slots, not the SFU or memory: per (t, n) about
// 7 f32 instructions besides the SFU op, plus the per-state scan, loads and
// loop.  At the falcon-mamba shape it took 1.124 ms with u in bf16 and
// 1.098 ms with u in f32, where the first design took 2.137 and 1.491 ms in
// the same process (H100 80GB HBM3, 700 W; PERF.md names the run and its
// script).  Measured slower in that run, at the bf16 shape, and not kept:
// an accurate expf (1.702 ms); unshifted ex2.approx (1.171 ms, and 143 y
// values past the gate with random A); 8 steps a thread in 4 segments at
// 256 threads a block and 64 registers (1.282 ms); delta and u loaded per
// chunk instead of staged (1.806 ms).  In earlier runs (PERF.md): the next
// state's decays formed inside this state's walk in the registers it frees
// (1.168 ms), formed under the current state's scan, and a state loop
// unrolled by two.
// A state beyond N gets A = 0 and B = C = 0, a step beyond S delta = u = 0
// and B = C = 0 (a = 1, b = 0: h and y unchanged), a channel beyond D
// computes channel D - 1 and stores nothing, so any S, D and N <= 16 run
// without padding; staging needs D % 8 == 0 and 16-byte aligned delta and
// u, other shapes load them per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;                // steps per chunk: kSeg segments of kL steps
constexpr int kCh = 64;               // channels per block
constexpr int kN = 16;                // states held per channel (Mamba-1's N)
constexpr int kTP = kT + 4;           // row stride of the B/C tables: 16-byte rows, and a
                                      // warp's segments in distinct bank groups
constexpr int kL = 16;                // steps a thread owns
constexpr int kSeg = kT / kL;         // segments a channel
constexpr int kChW = 32 / kSeg;       // channels a warp: lane = segment * kChW + channel
constexpr int kThreads = kCh * kSeg;  // threads a block
constexpr int kMinBlocks = 4;         // blocks an SM: 16 warps at 128 registers
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte cp.async; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// 16-byte cp.async; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}

// Column of channel c in row t of the [t][c] delta/u tiles: groups of a
// warp's kChW channels XOR-swizzled by the step's segment, so a warp's
// segments hit distinct banks.
__device__ __forceinline__ int swc(int t, int c) { return c ^ (((t / kL) % kSeg) * kChW); }

template <typename T>
constexpr int smem_bytes(bool stage) {
  return (2 * 2 * kN * kTP + 2 * kN * kCh) * 4 + (stage ? 2 * kT * kCh * (4 + sizeof(T)) : 0);
}

// 2 exp(x) for x = dt * A <= 0 (twice the decay: see the walk below), with
// an = A log2 e: ex2.approx.ftz(dt * an + 1), one FFMA and one SFU op.  The
// SFU's ex2 is least accurate, relative to 1 - 2^z, for z just below 0
// (decays near 1, whose error repeats over thousands of steps); shifted by
// one its input lies in (-inf, 1], as in expf's own range reduction, and
// the shift is the factor 2.
__device__ __forceinline__ float decay2(float dt, float an) { return ex2(fmaf(dt, an, 1.f)); }

// STAGE: delta and u reach shared memory by 16-byte cp.async, a chunk ahead
// (needs D % 8 == 0 and 16-byte aligned delta and u); else each thread
// loads its steps from global memory at the start of the chunk.
template <typename T, bool STAGE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ss_fwd(const T* __restrict__ u, const float* __restrict__ delta,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ hT,
           int S, int D, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sbc = reinterpret_cast<float*>(smem);  // [buffer][B, C][state][step, padded]
  float* s_a = sbc + 2 * 2 * kN * kTP;          // [state][channel]: A log2 e
  float* s_carry = s_a + kN * kCh;              // [state][channel]: h / 2 after the last chunk
  float* s_dt = s_carry + kN * kCh;             // [buffer][step][channel] (STAGE)
  T* s_u = reinterpret_cast<T*>(s_dt + 2 * kT * kCh);

  const int lane = threadIdx.x & 31;
  const int seg = lane / kChW;
  const int c = (threadIdx.x >> 5) * kChW + lane % kChW;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool active = d < D;
  const int dc = active ? d : D - 1;  // the ragged edge computes a real channel, stores nothing
  const long long row = static_cast<long long>(b) * S;

  for (int i = threadIdx.x; i < kCh * kN; i += kThreads) {
    const int n = i / kCh, cc = i % kCh;
    const int dd = min(d0 + cc, D - 1);
    const float a = n < N ? __ldg(A + static_cast<long long>(dd) * N + n) : 0.f;
    s_a[n * kCh + cc] = a * kLog2e;
    s_carry[n * kCh + cc] = 0.f;
  }

  // One chunk's inputs -> buffer buf, one cp.async group.  B and C: the
  // chunk's rows are kT * N contiguous floats, consecutive threads take
  // consecutive floats.  delta and u (STAGE): 16-byte pieces of each row.
  auto stage = [&](int t0, int buf) {
    constexpr int kBC = 2 * kT * kN;
    static_assert(kBC % kThreads == 0, "B/C staging takes whole rounds");
#pragma unroll
    for (int k = 0; k < kBC / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int which = i / (kT * kN), r = i % (kT * kN);
      const int t = r / kN, n = r % kN;
      const bool in = t0 + t < S && n < N;
      const float* base = which ? Cm : Bm;
      const float* src = in ? base + (row + t0 + t) * N + n : base;
      cp_async4(&sbc[((buf * 2 + which) * kN + n) * kTP + t], src, in);
    }
    if (STAGE) {
      constexpr int kPd = kCh / 4, kEu = 16 / sizeof(T), kPu = kCh / kEu;
      static_assert(kT * kPd % kThreads == 0 && kT * kPu % kThreads == 0, "whole rounds");
#pragma unroll
      for (int k = 0; k < kT * kPd / kThreads; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int t = i / kPd, c0 = (i % kPd) * 4;
        const bool in = t0 + t < S && d0 + c0 < D;
        const float* src = in ? delta + (row + t0 + t) * D + d0 + c0 : delta;
        cp_async16(&s_dt[(buf * kT + t) * kCh + swc(t, c0)], src, in);
      }
#pragma unroll
      for (int k = 0; k < kT * kPu / kThreads; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const int t = i / kPu, c0 = (i % kPu) * kEu;
        const bool in = t0 + t < S && d0 + c0 < D;
        const T* src = in ? u + (row + t0 + t) * D + d0 + c0 : u;
        cp_async16(&s_u[(buf * kT + t) * kCh + swc(t, c0)], src, in);
      }
    }
    cp_async_commit();
  };

  stage(0, 0);
  __syncthreads();

  const T* u_p = u + row * D + dc;
  const float* dl_p = delta + row * D + dc;
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const bool more = t0 + kT < S;
    if (more) stage(t0 + kT, buf ^ 1);
    const int ts = t0 + seg * kL;  // this thread's first step
    float dt[kL], du[kL], yv[kL];
    if (!STAGE) {
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const bool in = ts + j < S;
        const long long i = static_cast<long long>(ts + j) * D;
        dt[j] = in ? __ldg(dl_p + i) : 0.f;
        du[j] = in ? dt[j] * load_f32(u_p + i) * static_cast<float>(1 << j) : 0.f;
      }
    }
    if (more)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (STAGE) {
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        const int t = seg * kL + j;
        dt[j] = s_dt[(buf * kT + t) * kCh + swc(t, c)];
        du[j] = dt[j] * to_f32(s_u[(buf * kT + t) * kCh + swc(t, c)]) * static_cast<float>(1 << j);
      }
    }
#pragma unroll
    for (int j = 0; j < kL; ++j) yv[j] = 0.f;

    // The walk runs on g_j = 2^j h_j, which takes the doubled decays as they
    // come: g_j = (2 a_j) g_{j-1} + 2^j b_j, from g_{-1} = h_in / 2.  du
    // carries the 2^j (exact powers of two: the roundings are h's own), and
    // the scan and the carry hold half-states h / 2, so g_{-1} is the scan's
    // own value.
    const float* sb = sbc + (buf * 2) * kN * kTP + seg * kL;  // this segment's B steps
    const float* sa = s_a + c;                                // A of (state, channel)
#pragma unroll 1
    for (int n = 0; n < N; ++n, sb += kTP, sa += kCh) {
      const float an = sa[0];
      float a2[kL], bb[kL];
#pragma unroll
      for (int q = 0; q < kL / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(sb + 4 * q);
        bb[4 * q] = du[4 * q] * b4.x;
        bb[4 * q + 1] = du[4 * q + 1] * b4.y;
        bb[4 * q + 2] = du[4 * q + 2] * b4.z;
        bb[4 * q + 3] = du[4 * q + 3] * b4.w;
      }
#pragma unroll
      for (int j = 0; j < kL; ++j) a2[j] = decay2(dt[j], an);
      // fold this segment into one pair, h_end / 2 = pa (h_in / 2) + pb, as
      // a tree: (a, b) o (a', b') = (a a', a' b + b'), kL - 1 combines,
      // depth log2 kL
      float fa[kL], fb[kL];
#pragma unroll
      for (int j = 0; j < kL; ++j) {
        fa[j] = a2[j];
        fb[j] = bb[j];
      }
#pragma unroll
      for (int w = 1; w < kL; w *= 2) {
#pragma unroll
        for (int j = 0; j < kL; j += 2 * w) {
          fb[j] = fmaf(fa[j + w], fb[j], fb[j + w]);
          fa[j] *= fa[j + w];
        }
      }
      float pa = fa[0] * (1.f / (1 << kL));  // the decays' doubling
      float pb = fb[0];
      pb *= 1.f / (1 << kL);  // g_{kL-1} = 2^(kL-1) h, and the half
      // the pairs of the segments before this one, in one shuffle latency
      float qa[kSeg], qb[kSeg];
#pragma unroll
      for (int k = 1; k < kSeg; ++k) {
        qa[k] = __shfl_up_sync(0xffffffffu, pa, k * kChW);
        qb[k] = __shfl_up_sync(0xffffffffu, pb, k * kChW);
      }
      // the half-state entering this segment: the carry folded through the earlier ones
      float g = sa[kN * kCh];
      __syncwarp();  // every lane has read the carry before the last segment rewrites it
#pragma unroll
      for (int k = kSeg - 1; k >= 1; --k) {
        if (seg >= k) g = fmaf(qa[k], g, qb[k]);
      }
      if (seg == kSeg - 1) s_carry[n * kCh + c] = fmaf(pa, g, pb);
#pragma unroll
      for (int q = 0; q < kL / 4; ++q) {
        const float4 c4 = *reinterpret_cast<const float4*>(sb + kN * kTP + 4 * q);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          g = fmaf(a2[4 * q + e], g, bb[4 * q + e]);
          yv[4 * q + e] = fmaf(g, cv[e], yv[4 * q + e]);  // 2^j y_j
        }
      }
    }

    if (active) {
      float* y_p = y + (row + ts) * D + d;
      const int steps = S - ts;
      if (steps >= kL) {
#pragma unroll
        for (int j = 0; j < kL; ++j) y_p[static_cast<long long>(j) * D] = yv[j] * (1.f / (1 << j));
      } else {
#pragma unroll
        for (int j = 0; j < kL; ++j) {
          if (j < steps) y_p[static_cast<long long>(j) * D] = yv[j] * (1.f / (1 << j));
        }
      }
    }
    __syncthreads();  // the buffers are read before they are rewritten, the carry written
    buf ^= 1;
  }
  cp_async_wait<0>();  // S = 0 leaves the first (empty) group in flight

  for (int i = threadIdx.x; i < kCh * N; i += kThreads) {
    const int cc = i / N, n = i % N;
    if (d0 + cc < D)
      hT[(static_cast<long long>(b) * D + d0 + cc) * N + n] = 2.f * s_carry[n * kCh + cc];
  }
}

template <typename T, bool STAGE>
int launch(const void* u, const float* delta, const float* A, const float* Bm, const float* Cm,
           float* y, float* hT, int B, int S, int D, int N, cudaStream_t st) {
  auto kernel = ss_fwd<T, STAGE>;
  constexpr int bytes = smem_bytes<T>(STAGE);
  static bool attr_set = false;  // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((D + kCh - 1) / kCh, B);
  kernel<<<grid, kThreads, bytes, st>>>(static_cast<const T*>(u), delta, A, Bm, Cm, y, hT, S, D,
                                        N);
  return static_cast<int>(cudaGetLastError());
}

// Staging needs D % 8 == 0 and 16-byte aligned delta and u.
template <typename T>
int dispatch(const void* u, const float* delta, const float* A, const float* Bm, const float* Cm,
             float* y, float* hT, int B, int S, int D, int N, cudaStream_t st) {
  const bool aligned = D % 8 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  return aligned ? launch<T, true>(u, delta, A, Bm, Cm, y, hT, B, S, D, N, st)
                 : launch<T, false>(u, delta, A, Bm, Cm, y, hT, B, S, D, N, st);
}

}  // namespace

extern "C" {

// u: contiguous (B, S, D), bf16 if u_bf16 else f32; delta (B, S, D), A (D, N),
// Bm and Cm (B, S, N) contiguous f32, N <= 16 -> y (B, S, D), hT (B, D, N)
// f32.  Returns cudaGetLastError() after the launch.
int selective_scan_forward(const void* u, int u_bf16, const float* delta, const float* A,
                           const float* Bm, const float* Cm, float* y, float* hT, int B, int S,
                           int D, int N, void* stream) {
  if (B <= 0 || D <= 0 || S < 0) return 0;
  if (B > 65535 || N < 1 || N > kN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return u_bf16 ? dispatch<__nv_bfloat16>(u, delta, A, Bm, Cm, y, hT, B, S, D, N, st)
                : dispatch<float>(u, delta, A, Bm, Cm, y, hT, B, S, D, N, st);
}

}  // extern "C"
