// Hopper (sm_90a) flash-attention forward, hand-written in CUDA C++ and bound
// through a plain C interface (ctypes, see ../cuda.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:94
// flash_attention_call (_flash_kernel :34; wrapper ops.py:12): online-softmax
// attention with causal masking, a sliding window, tanh logit softcapping and
// GQA by index, f32 softmax, the output in v's type.  Two bodies share the C
// entry fa_forward: a tensor-core body for bf16 and a CUDA-core body for f32.
//
// What bounds it: operations.  At the recurrentgemma-9b local-layer shape
// (B 4, S = T = 4096, Nq 16, Nkv 1, H 256, window 2048) the band needs 4 H
// FLOPs for each of 6.3e6 (query, key) pairs per head, 4.1e11 FLOPs, 0.417 ms
// at 989 TFLOP/s, against 0.29 GB of q, k, v and out (0.085 ms at 3.35 TB/s).
// At the stablelm-1.6b shape (B 4, S 512, Nq = Nkv = 32, H 64, causal) the
// band is 4.3e9 FLOPs (0.004 ms) against 34 MB (0.010 ms): bytes, and at that
// size the launch and the first tile's latency dominate.
//
// bf16 body (flash_fwd_tc): the products on the tensor cores with wgmma, K/V
// tiles by TMA, warp-specialised.
//  * Block: the query rows of one (batch, query head), in consumer
//    warpgroups of 64 rows, plus one producer warpgroup whose first thread
//    issues every TMA copy.  H 256: two consumers (128 rows, 384 threads), one
//    block per SM.  H 64 and 128: one consumer (64 rows, 256 threads), three
//    or two blocks per SM, so that short sequences overlap one block's start
//    and end with another's products.  setmaxnreg gives the producer 24
//    registers and the consumers the rest of the block's share: 240 / 232 /
//    136 a thread at H 256 / 128 / 64.
//  * Shared memory: the Q tile (rows x H bf16, one TMA box per 64 columns,
//    loaded once) and a 2-stage ring of K and V tiles of 64 keys, each
//    64-column slab a 128-byte-swizzled TMA box (CU_TENSOR_MAP_SWIZZLE_128B),
//    the layout the wgmma descriptors name (layout type B128: K-major for Q
//    and K, MN-major for V).  At H 256: 64 KB + 2 x (32 + 32) KB = 192 KB.
//    Each stage has a full barrier for K and one for V (TMA completes their
//    byte counts) and an empty barrier for each (one arrival per consumer
//    warpgroup), so K of tile i + 2 loads as soon as the QK^T of tile i is
//    done, while V of tile i is still read.
//  * QK^T: wgmma m64n64k16, Q and K from shared memory (K-major), f32
//    accumulator in registers.  PV: wgmma m64nHk16 with P as the register A
//    operand and V as the MN-major (transposed) B operand: V is not re-laid
//    out in device memory.  Descriptors are a base plus an immediate offset
//    per k-slice, so one base per operand stays live.
//  * Per consumer warpgroup the loop is software-pipelined: QK^T of tile j
//    and PV of tile j - 1 are issued together, and the softmax of tile j runs
//    on the CUDA cores while PV is on the tensor cores; two consumers overlap
//    each other likewise.  No branch lies between a wgmma and its wait, or
//    ptxas serialises every wgmma (its C7514 / C7520 notes); hence three
//    loops (masked prefix, unmasked middle, masked suffix) and predicated
//    barrier arrivals.  Explicit ping-pong turns between the two consumers
//    (named barriers) measured slower and were left out.
//  * Softmax in f32 on the accumulator fragment: scale * log2(e) folded into
//    one multiply of the scores and ex2.approx; softcap, where set, as tanhf
//    on the f32 scores before the mask; the reference's guards
//    (kernel.py:70-74, 88): a masked score is -2e38, m is taken as 0 while it
//    is still -2e38, p and the correction are 0 there, the final l is clamped
//    at 1e-30.  Row sums stay per thread until the end (the correction is
//    uniform over the four threads of a row).
//  * P for the PV product is split into two bf16 terms, P = hi + lo with
//    hi = bf16(P) and lo = bf16(P - hi), and both go through the tensor cores:
//    PV costs two products, 1.5x the FLOPs of QK^T + PV.  P rounded once to
//    bf16 errs by 2^-9 relative per weight, ~4e-5 absolute at a 2048-key
//    window, but that error does not shrink with |out| where the weighted
//    sum cancels: there |out| falls toward 0 while the error stays at the
//    size of the weights' rounding, and outputs fall past the bf16 gate
//    (1e-4 + 1e-2 |plain|, whose relative term shrinks with |out|).  With
//    the split the weights carry 16 bits, 2^-17 relative, and every output
//    of the card's bf16 cases (phase 5 of chip_smoke.py, FLASH_CASES) stays
//    inside the gate.  QK^T from bf16 operands with f32 accumulation is
//    exact per product.
//  * Band: key tiles wholly outside the causal or window band of a block are
//    never loaded; a consumer passes over the tiles outside its own rows'
//    band (waits for them and releases them, no products); only tiles that
//    cross a band edge, or the end of the keys, evaluate the mask.  Keys
//    past T and rows past S are zero-filled by TMA; keys past T are masked
//    and rows past S are not written.  S != T works, positions aligned at 0.
//  * GQA is an index: the KV head of query head n is n / G, never
//    replicated.  Blocks run in (batch, KV head)-major order, then q tiles
//    (the longest first), then the G query heads of the group, so blocks
//    that read the same K/V tiles run together and share them through L2.
//  * Output: after the last tile each consumer scales by 1 / l, stages its
//    64 x H bf16 rows in its (consumed) Q rows of shared memory, swizzled,
//    and writes them with 16 bytes a thread.
//  * TMA descriptors: 4-D (H, rows, heads, batch) maps over q, k and v in
//    their (B, S|T, N, H) layouts, encoded per call with
//    cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (no
//    -lcuda), passed as __grid_constant__ kernel parameters.  TMA needs
//    16-byte aligned bases and strides; the wrapper refuses anything else.
//  * ptxas -v (chip_smoke.py's build phase, nvcc 12.9): 168 / 128 / 80
//    registers at entry for H 256 / 128 / 64 (the launch bounds' share),
//    0 bytes of spills, 16 barriers.  (A __trap() guard in the barrier wait
//    loop had cost 1.4 KB of spills at H 256.)
//
// f32 body (flash_fwd_f32): the products on the CUDA cores in f32.  The
// tensor cores take f32 only as TF32 (10-bit mantissa), which would break the
// reference's 3e-5 f32 gate, and the repo keeps TF32 off by design; f32
// attention is on no full-width serving path (only the tests and the reduced
// configs, whose activations are f32).
//  * one block per (tile of 64 query rows, query head, batch): 256 threads;
//    thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 16 i (i < 4), the
//    score columns tc + 16 j (j < 4) of each key tile and the output columns
//    tc + 16 j (j < H / 16), so a row's 16 threads are one half-warp and its
//    max and sum reduce with four shuffles;
//  * a loop over key tiles of 64 staged in shared memory (q, k and v tiles in
//    f32, rows padded by one float against bank conflicts; 209 KB at H 256);
//  * the running (m, l, acc) in registers with the guards above; key tiles
//    wholly outside the band are skipped; q, k and v read through strides.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kNegInf = -2.0e38f;

// ---------------------------------------------------------------------------
// f32 body: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;  // contiguous (B, S, Nq, H)
  int S, T, Nq, G;
  long long qb, qs, qn, kb, ks, kn, vb, vs, vn;  // element strides
  int causal;
  int window;     // <= 0: no window
  float softcap;  // <= 0: no softcap
  float scale;
};

template <int H>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (H + 1) + kBK * (H + 1) + kBK * H + kBQ * (kBK + 1));
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Params p) {
  extern __shared__ float smem[];
  constexpr int LD = H + 1;
  constexpr int LDP = kBK + 1;
  constexpr int kOut = H / 16;
  float* Qs = smem;            // kBQ x LD
  float* Ks = Qs + kBQ * LD;   // kBK x LD
  float* Vs = Ks + kBK * LD;   // kBK x H
  float* Ps = Vs + kBK * H;    // kBQ x LDP

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int n = blockIdx.y, b = blockIdx.z;
  const int nkv = n / p.G;
  const float* q = static_cast<const float*>(p.q) + b * p.qb + n * p.qn;
  const float* k = static_cast<const float*>(p.k) + b * p.kb + nkv * p.kn;
  const float* v = static_cast<const float*>(p.v) + b * p.vb + nkv * p.vn;

  for (int i = tid; i < kBQ * H; i += kThreads) {
    const int r = i / H, h = i % H;
    const int qi = q0 + r;
    Qs[r * LD + h] = qi < p.S ? q[qi * p.qs + h] * p.scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[i][j] = 0.f;
  }

  // Key tiles that can hold a valid key for some row of this block.
  int k_lo = 0, k_hi = p.T;
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  if (p.causal) k_hi = min(p.T, q0 + kBQ);
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kBK * H; i += kThreads) {
      const int r = i / H, h = i % H;
      const int kj = k0 + r;
      const bool in = kj < p.T;
      Ks[r * LD + h] = in ? k[kj * p.ks + h] : 0.f;
      Vs[r * H + h] = in ? v[kj * p.vs + h] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int h = 0; h < H; ++h) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + 16 * i) * LD + h];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + 16 * j) * LD + h];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = tr + 16 * i;
      const int qi = q0 + r;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tc + 16 * j;
        float x = s[i][j];
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool valid = kj < p.T;
        if (p.causal) valid = valid && kj <= qi;
        if (p.window > 0) valid = valid && (qi - kj) < p.window;
        x = valid ? x : kNegInf;
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[i], mc);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float corr = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = s[i][j] <= kNegInf / 2 ? 0.f : expf(s[i][j] - m_safe);
        Ps[r * LDP + tc + 16 * j] = pj;
        ps += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = Vs[c * H + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long base = ((static_cast<long long>(b) * p.S + qi) * p.Nq + n) * H;
#pragma unroll
    for (int j = 0; j < kOut; ++j) o[base + tc + 16 * j] = acc[i][j] / denom;
  }
}

template <int H>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + kBQ - 1) / kBQ, p.Nq, B);
  flash_fwd_f32<H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body: tensor cores (wgmma), TMA, warp-specialised
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kSlab = 64;        // bf16 columns of one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

// The block's shape and register split by head width (see the note at the top).
template <int H>
struct Cfg {
  static constexpr int kWGs = H == 256 ? 2 : 1;          // consumer warpgroups
  static constexpr int kBlocksPerSM = H == 64 ? 3 : (H == 128 ? 2 : 1);
  static constexpr int kBQ = 64 * kWGs;                  // query rows per block
  static constexpr int kThreads = 128 * (kWGs + 1);      // + the producer warpgroup
  static constexpr int kProducerRegs = 24;
  static constexpr int kEntryRegs = (65536 / (kThreads * kBlocksPerSM)) & ~7;
  static constexpr int kConsumerRegs =
      (kEntryRegs + 128 * (kEntryRegs - kProducerRegs) / (128 * kWGs)) & ~7;
  static constexpr int BK = 64;                         // keys per tile
  static constexpr int kQSlab = kBQ * 128;              // bytes of one 64-column slab of Q
  static constexpr int kKVSlab = BK * 128;              // ... of K or V
  static constexpr int kQBytes = kQSlab * (H / kSlab);
  static constexpr int kKVBytes = kKVSlab * (H / kSlab);
  static constexpr int kBarOffset = kQBytes + 4 * kKVBytes;
  static constexpr int kSmem = kBarOffset + 9 * 8 + 1024;  // + 9 barriers, + alignment
};

struct Args {
  __nv_bfloat16* o;  // contiguous (B, S, Nq, H)
  int S, T, Nq, Nkv, G, nqt;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on `bar` from the threads where `pred` holds.  The predicate is
// inside the instruction, not a branch: a branch between wgmma instructions
// makes ptxas serialise them.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// -- TMA ------------------------------------------------------------------------

// One box of a 4-D map (H, rows, heads, batch) into shared memory at `dst`,
// completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled tile (layout type B128) at shared
// address `addr`: `lbo` and `sbo` in bytes.  K-major (Q, K): sbo = 1024, the
// stride of 8-row groups, lbo unused (16).  MN-major (V): lbo = the stride of
// 64-column slabs, sbo = 1024, the stride of 8-key groups.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes at this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The wgmma shapes the kernel uses.  The descriptors come as a base plus an
// offset that is an immediate of the instruction (in 16-byte units): the
// compiler then keeps one base per operand live, not one descriptor per
// k-slice and stage.
//
// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A at a + OA and B at b + OB in
// shared memory, both K-major; acc = 0 overwrites D.
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "add.s64 da, %32, %35;\n"
      "add.s64 db, %33, %36;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(OA), "n"(OB));
}


// D[64 x N] += A[64 x 16] B[16 x N]: A in registers (bf16 pairs in the
// accumulator's fragment order), B at b + OB in shared memory, MN-major.

template <int OB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %36, %38;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(OB));
}


template <int OB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %68, %70;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(OB));
}


template <int OB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "add.s64 db, %132, %134;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(OB));
}

template <int N, int OB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64<OB>(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128<OB>(d, a, b);
  } else {
    wgmma_rs_n256<OB>(d, a, b);
  }
}

// -- the block ---------------------------------------------------------------------

// 2^x in one MUFU.EX2 (exp2f adds range handling for results below 2^-126,
// which the softmax flushes to 0 harmlessly: l >= 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keys [lo, hi) that some row of [r_lo, r_hi) may see; empty when hi <= lo.
__device__ __forceinline__ void key_range(const Args& p, int r_lo, int r_hi, int& lo, int& hi) {
  lo = p.window > 0 ? max(0, r_lo - p.window + 1) : 0;
  hi = p.causal ? min(p.T, r_hi) : p.T;
  if (r_hi <= r_lo) hi = lo;
}

// The scores of one tile (the QK^T fragment) -> unnormalised probabilities in
// place, the running max m and row sum l updated, corr the factor for the
// output.  Thread (warp w, lane) holds rows row0 and row0 + 8 (index h) and
// columns k0 + 8 j + 2 (lane % 4) + c of its register 4 j + 2 h + c.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Args& p, int row0, int k0,
                                             int lane) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    float x = s[e];
    if (p.softcap > 0.f) {
      x = tanhf(x * (p.scale / p.softcap)) * (p.softcap * kLog2e);
    } else {
      x *= p.scale * kLog2e;
    }
    if (kMask) {
      const int kj = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      const int qi = row0 + 8 * ((e >> 1) & 1);
      bool valid = kj < p.T;
      if (p.causal) valid = valid && kj <= qi;
      if (p.window > 0) valid = valid && (qi - kj) < p.window;
      x = valid ? x : kNegInf;
    }
    s[e] = x;
    mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
  }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    ms[h] = mx[h] <= kNegInf / 2 ? 0.f : mx[h];
    corr[h] = m[h] <= kNegInf / 2 ? 0.f : ex2(m[h] - ms[h]);
    m[h] = mx[h];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    const int h = (e >> 1) & 1;
    float pe = ex2(s[e] - ms[h]);
    if (kMask) pe = s[e] <= kNegInf / 2 ? 0.f : pe;
    s[e] = pe;
    rs[h] += pe;
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// P (f32 fragment) -> the A operands of PV, as bf16 pairs hi = bf16(P) and
// lo = bf16(P - hi): registers 8 kk .. 8 kk + 7 are k-slice kk's a0 .. a7.
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h2);
      const __nv_bfloat162 l2 = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(&l2);
    }
}

template <int BK>
__device__ __forceinline__ void softmax_any(bool mask, float (&s)[BK / 2], float (&m)[2],
                                            float (&l)[2], float (&corr)[2], const Args& p,
                                            int row0, int k0, int lane) {
  if (mask) {
    softmax_tile<BK, true>(s, m, l, corr, p, row0, k0, lane);
  } else {
    softmax_tile<BK, false>(s, m, l, corr, p, row0, k0, lane);
  }
}

// Does the key tile at k0 cross an edge of the band (or the end of the keys)
// for some of the 64 rows from r0?
__device__ __forceinline__ bool crosses(const Args& p, int k0, int bk, int r0) {
  return k0 + bk > p.T || (p.causal && k0 + bk - 1 > r0) ||
         (p.window > 0 && r0 + 63 - k0 >= p.window);
}

// S = Q_wg K^T over H / 16 k-slices KK: the Q rows of this warpgroup (base
// descriptor dq) and a K tile (dk), both K-major, each 64-column slab a
// swizzled block of 128-byte rows.
template <int H, int... KK>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<H>::BK / 2], uint64_t dq, uint64_t dk,
                                         std::integer_sequence<int, KK...>) {
  using C = Cfg<H>;
  (wgmma_ss_n64<(((KK >> 2) * C::kQSlab + (KK & 3) * 32) >> 4),
                (((KK >> 2) * C::kKVSlab + (KK & 3) * 32) >> 4)>(s, dq, dk, KK > 0),
   ...);
}

// O += (P_hi + P_lo) V over BK / 16 k-slices KK of 16 keys; V (dv) MN-major.
template <int H, int... KK>
__device__ __forceinline__ void issue_pv(float (&o)[H / 2], const uint32_t (&hi)[Cfg<H>::BK / 16][4],
                                         const uint32_t (&lo)[Cfg<H>::BK / 16][4], uint64_t dv,
                                         std::integer_sequence<int, KK...>) {
  ((wgmma_rs<H, (KK * 16 * 128 >> 4)>(o, hi[KK], dv), wgmma_rs<H, (KK * 16 * 128 >> 4)>(o, lo[KK], dv)),
   ...);
}

// A tile outside this warpgroup's band: every thread waits for it (so the
// barrier cannot run a phase ahead of a lagging warp), then it is released.
__device__ __forceinline__ void pass_tile(int i, uint32_t k_full, uint32_t v_full, uint32_t k_empty,
                                          uint32_t v_empty, int wg, int tw) {
  const int s = i & 1;
  const uint32_t par = (i >> 1) & 1;
  mbar_wait(k_full + 8 * s, par);
  mbar_wait(v_full + 8 * s, par);
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  mbar_arrive_if(k_empty + 8 * s, tw == 0);
  mbar_arrive_if(v_empty + 8 * s, tw == 0);
}

// One consumer thread's registers.
template <int H>
struct Frag {
  float s[Cfg<H>::BK / 2];          // the tile's scores, then its probabilities
  float o[H / 2];                   // the output accumulator
  uint32_t hi[Cfg<H>::BK / 16][4];  // P's two bf16 terms: the A operands of PV
  uint32_t lo[Cfg<H>::BK / 16][4];
  float m[2], l[2], corr[2];        // running max (log2 units) and sum, rescale factor
};

// What a consumer warpgroup needs of the block: the K/V ring and its
// barriers, the descriptor of its Q rows, its rows and tiles.
struct Ring {
  uint32_t sK, sV, k_full, v_full, k_empty, v_empty;
  uint64_t dq;
  int t_lo, row0, lane;
  bool leader;  // the warpgroup's first thread, which releases tiles
};

// Issue S = Q K^T of tile j (async).
template <int H>
__device__ __forceinline__ void qk(Frag<H>& f, const Ring& r, int j) {
  const int st = j & 1;
  mbar_wait(r.k_full + 8 * st, (j >> 1) & 1);
  pin(f.s);
  wgmma_fence();
  issue_qk<H>(f.s, r.dq, desc_b128(r.sK + st * Cfg<H>::kKVBytes, 16, 1024),
              std::make_integer_sequence<int, H / 16>{});
  wgmma_commit();
}

// Rescale O by the last softmax's correction and issue O += P V of tile j (async).
template <int H>
__device__ __forceinline__ void pv(Frag<H>& f, const Ring& r, int j) {
  using C = Cfg<H>;
  const int st = j & 1;
#pragma unroll
  for (int i = 0; i < H / 2; ++i) f.o[i] *= f.corr[(i >> 1) & 1];
  mbar_wait(r.v_full + 8 * st, (j >> 1) & 1);
  pin(f.o);
  pin(f.hi);
  pin(f.lo);
  wgmma_fence();
  issue_pv<H>(f.o, f.hi, f.lo, desc_b128(r.sV + st * C::kKVBytes, C::kKVSlab, 1024),
              std::make_integer_sequence<int, C::BK / 16>{});
  wgmma_commit();
}

// One step of the pipelined loop: QK^T of tile j and PV of tile j - 1 go to
// the tensor cores together; the softmax of tile j runs on the CUDA cores
// while PV does.  kMask: tile j crosses an edge of the band.  No branch lies
// between an issue and its wait (ptxas would serialise the wgmma).
template <int H, bool kMask>
__device__ __forceinline__ void step(Frag<H>& f, const Ring& r, const Args& p, int j) {
  constexpr int BK = Cfg<H>::BK;
  qk<H>(f, r, j);
  pv<H>(f, r, j - 1);
  wgmma_wait<1>();  // QK^T of tile j is done
  pin(f.s);
  mbar_arrive_if(r.k_empty + 8 * (j & 1), r.leader);
  softmax_tile<BK, kMask>(f.s, f.m, f.l, f.corr, p, r.row0, (r.t_lo + j) * BK, r.lane);
  wgmma_wait<0>();  // PV of tile j - 1 is done
  pin(f.o);
  pin(f.hi);
  pin(f.lo);
  mbar_arrive_if(r.v_empty + 8 * ((j - 1) & 1), r.leader);
  split_p<BK>(f.s, f.hi, f.lo);
}

template <int H>
__global__ void __launch_bounds__(Cfg<H>::kThreads, Cfg<H>::kBlocksPerSM)
    flash_fwd_tc(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv, const Args p) {
  using C = Cfg<H>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // swizzled tiles want 1024-byte alignment
  const uint32_t sK = sQ + C::kQBytes;         // 2 stages
  const uint32_t sV = sK + 2 * C::kKVBytes;    // 2 stages
  const uint32_t bar = sQ + C::kBarOffset;
  const uint32_t q_full = bar;
  // stage s: k_full + 8 s, v_full + 8 s, k_empty + 8 s, v_empty + 8 s
  const uint32_t k_full = bar + 8, v_full = bar + 24, k_empty = bar + 40, v_empty = bar + 56;

  // (batch, KV head)-major, then q tiles (longest first), then the group's heads
  int idx = blockIdx.x;
  const int g = idx % p.G;
  idx /= p.G;
  const int qt = p.nqt - 1 - idx % p.nqt;
  idx /= p.nqt;
  const int kvh = idx % p.Nkv;
  const int b = idx / p.Nkv;
  const int n = kvh * p.G + g;
  const int q0 = qt * C::kBQ;

  int lo, hi;
  key_range(p, q0, min(p.S, q0 + C::kBQ), lo, hi);
  const int t_lo = lo / BK;
  const int ntiles = hi > lo ? (hi + BK - 1) / BK - t_lo : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, C::kWGs);
      mbar_init(v_empty + 8 * s, C::kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, broadcast from lane 0 so that the compiler sees it is
  // warp-uniform: the branches on it are then not divergent, and setmaxnreg
  // and the wgmma pipeline hold
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == C::kWGs) {
    // ---- producer: one thread issues every copy --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (tid == 128 * C::kWGs && ntiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < H / kSlab; ++c) tma_load(sQ + c * C::kQSlab, &tq, c * kSlab, q0, n, b, q_full);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i & 1, u = i >> 1, k0 = (t_lo + i) * BK;
        if (u > 0) mbar_wait(k_empty + 8 * s, (u - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < H / kSlab; ++c)
          tma_load(sK + s * C::kKVBytes + c * C::kKVSlab, &tk, c * kSlab, k0, kvh, b, k_full + 8 * s);
        if (u > 0) mbar_wait(v_empty + 8 * s, (u - 1) & 1);
        mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
#pragma unroll
        for (int c = 0; c < H / kSlab; ++c)
          tma_load(sV + s * C::kKVBytes + c * C::kKVSlab, &tv, c * kSlab, k0, kvh, b, v_full + 8 * s);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int tw = tid & 127, lane = tid & 31, warp = tw >> 5;
    const int r0 = q0 + 64 * wg;
    const int row0 = r0 + 16 * warp + (lane >> 2);

    // this warpgroup's tiles [a, e) among the block's [0, ntiles)
    int wlo, whi;
    key_range(p, r0, min(p.S, r0 + 64), wlo, whi);
    int a = 0, e = 0;
    if (whi > wlo) {
      a = wlo / BK - t_lo;
      e = (whi + BK - 1) / BK - t_lo;
    }
    for (int i = 0; i < a; ++i) pass_tile(i, k_full, v_full, k_empty, v_empty, wg, tw);

    Frag<H> f;
#pragma unroll
    for (int i = 0; i < H / 2; ++i) f.o[i] = 0.f;
    f.m[0] = f.m[1] = kNegInf;
    f.l[0] = f.l[1] = 0.f;

    if (a < e) {
      const Ring ring{sK, sV, k_full, v_full, k_empty, v_empty,
                      desc_b128(sQ + wg * 64 * 128, 16, 1024), t_lo, row0, lane, tw == 0};
      mbar_wait(q_full, 0);
      qk<H>(f, ring, a);
      wgmma_wait<0>();
      pin(f.s);
      mbar_arrive_if(k_empty + 8 * (a & 1), tw == 0);
      softmax_any<BK>(crosses(p, (t_lo + a) * BK, BK, r0), f.s, f.m, f.l, f.corr, p, row0, (t_lo + a) * BK, lane);
      split_p<BK>(f.s, f.hi, f.lo);
      // Tiles that cross an edge of the band are a prefix (the window's) and
      // a suffix (the diagonal's, the end of the keys): three loops, so the
      // mask is a compile-time choice inside each.
      int j1 = a + 1;
      while (j1 < e && crosses(p, (t_lo + j1) * BK, BK, r0)) ++j1;
      int j2 = j1;
      while (j2 < e && !crosses(p, (t_lo + j2) * BK, BK, r0)) ++j2;
      for (int j = a + 1; j < j1; ++j) step<H, true>(f, ring, p, j);
      for (int j = j1; j < j2; ++j) step<H, false>(f, ring, p, j);
      for (int j = j2; j < e; ++j) step<H, true>(f, ring, p, j);
      pv<H>(f, ring, e - 1);
      wgmma_wait<0>();
      pin(f.o);
      mbar_arrive_if(v_empty + 8 * ((e - 1) & 1), tw == 0);
    }

    // ---- epilogue: 1 / l, stage the rows in this warpgroup's Q rows, 16 B a thread
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      f.l[h] += __shfl_xor_sync(0xffffffffu, f.l[h], 1);
      f.l[h] += __shfl_xor_sync(0xffffffffu, f.l[h], 2);
      f.l[h] = 1.f / fmaxf(f.l[h], 1e-30f);
    }
    if (ntiles > 0) mbar_wait(q_full, 0);  // the Q rows that take the output have landed
    uint8_t* tile = smem_raw + (sQ - raw);
#pragma unroll
    for (int j = 0; j < H / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + (lane >> 2) + 8 * h;  // row within the warpgroup's 64
        const int off = (j >> 3) * C::kQSlab + (64 * wg + r) * 128 + (((j & 7) ^ (r & 7)) << 4) +
                        4 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(tile + off) =
            __floats2bfloat162_rn(f.o[4 * j + 2 * h] * f.l[h], f.o[4 * j + 2 * h + 1] * f.l[h]);
      }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    constexpr int kUnits = H / 8;  // 16-byte units in a row
    for (int u = tw; u < 64 * kUnits; u += 128) {
      const int r = u / kUnits, c = u % kUnits;
      const int qi = r0 + r;
      if (qi < p.S) {
        const int off = (c >> 3) * C::kQSlab + (64 * wg + r) * 128 + (((c & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(p.o + ((static_cast<long long>(b) * p.S + qi) * p.Nq + n) * H + 8 * c) =
            *reinterpret_cast<const uint4*>(tile + off);
      }
    }
    for (int i = e; i < ntiles; ++i) pass_tile(i, k_full, v_full, k_empty, v_empty, wg, tw);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (H, rows, heads, batch) over a (B, rows, heads, H) bf16 tensor with
// element strides sb, sr, sn and unit stride over H; boxes of 64 columns x
// `box_rows` rows, 128-byte swizzled, zero-filled past the ends.  A stride of
// a dimension of size 1 is never used and is replaced by a valid one.
bool make_map(CUtensorMap* map, const void* base, int H, int rows, int heads, int B,
              long long sr, long long sn, long long sb, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const long long row_bytes = 2ll * H;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(rows > 1 ? 2 * sr : row_bytes),
                           static_cast<cuuint64_t>(heads > 1 ? 2 * sn : row_bytes),
                           static_cast<cuuint64_t>(B > 1 ? 2 * sb : row_bytes)};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(kSlab), static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
cudaError_t launch(const Params& p, int B, int Nkv, cudaStream_t stream) {
  using C = Cfg<H>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, H, p.S, p.Nq, B, p.qs, p.qn, p.qb, C::kBQ) ||
      !make_map(&tk, p.k, H, p.T, Nkv, B, p.ks, p.kn, p.kb, C::BK) ||
      !make_map(&tv, p.v, H, p.T, Nkv, B, p.vs, p.vn, p.vb, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmem);
  if (err != cudaSuccess) return err;
  const int nqt = (p.S + C::kBQ - 1) / C::kBQ;
  Args a{static_cast<__nv_bfloat16*>(p.o), p.S, p.T, p.Nq, Nkv, p.G, nqt,
         p.causal, p.window, p.softcap, p.scale};
  flash_fwd_tc<H><<<B * Nkv * nqt * p.G, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// q, k, v: (B, S|T, N, H) with unit stride over H and the element strides
// given; o: contiguous (B, S, Nq, H).  bf16 = 1 for bfloat16 inputs and output
// (the tensor-core body: 16-byte aligned bases and strides), 0 for float32
// (the CUDA-core body).  Returns cudaGetLastError() after the launch.
int fa_forward(int bf16, int H, const void* q, const void* k, const void* v, void* o, int B,
               int S, int T, int Nq, int Nkv, long long qb, long long qs, long long qn,
               long long kb, long long ks, long long kn, long long vb, long long vs,
               long long vn, int causal, int window, float softcap, float scale,
               void* stream) {
  if (S <= 0 || B <= 0) return 0;
  if (Nkv <= 0 || Nq % Nkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, S, T, Nq, Nq / Nkv, qb, qs, qn, kb, ks, kn, vb, vs, vn,
           causal, window, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (H) {
    case 64: err = bf16 ? tc::launch<64>(p, B, Nkv, st) : launch_f32<64>(p, B, st); break;
    case 128: err = bf16 ? tc::launch<128>(p, B, Nkv, st) : launch_f32<128>(p, B, st); break;
    case 256: err = bf16 ? tc::launch<256>(p, B, Nkv, st) : launch_f32<256>(p, B, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
