// Hopper (sm_90a) flash-attention forward, hand-written in CUDA C++ and bound
// through a plain C interface (ctypes, see ../cuda.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:94
// flash_attention_call (_flash_kernel :34; wrapper ops.py:12): online-softmax
// attention with causal masking, a sliding window, tanh logit softcapping and
// GQA by index, f32 math, the output in v's type.
//
// What bounds it: operations.  At the recurrentgemma-9b local-layer shape
// (B 4, S = T = 4096, Nq 16, Nkv 1, H 256, window 2048) the band needs
// 4 * H FLOPs for each of ~6.3e6 (query, key) pairs per head, ~4.1e11 FLOPs,
// against ~0.29 GB of q, k, v and out: far above the ~295 FLOP/byte ridge.
// This first kernel runs the products on the CUDA cores in f32 (no wgmma, no
// TMA yet), so it sits well behind the tensor-core bound; the point here is
// the reference's numbers, the TPU kernel's exact masking and guard rules.
//
// Design, for the GPU rather than from the TPU's tiling:
//  * one block per (tile of 64 query rows, query head, batch): 256 threads;
//    thread (tr, tc) = (tid / 16, tid % 16) owns rows tr + 16 i (i < 4), the
//    score columns tc + 16 j (j < 4) of each key tile and the output columns
//    tc + 16 j (j < H / 16), so a row's 16 threads are one half-warp and its
//    max and sum reduce with four shuffles;
//  * a loop over key tiles of 64 staged in shared memory (q tile, k tile and v
//    tile in f32, rows padded by one float against bank conflicts; 209 KB at
//    H = 256, hence cudaFuncSetAttribute);
//  * the running (m, l, acc) live in registers in f32, with the reference's
//    guards for fully masked rows (kernel.py:70-74): a masked score is -2e38,
//    m is taken as 0 while it is still -2e38, p and the correction are 0 there;
//  * key tiles wholly outside the causal or window band are skipped: such a
//    tile would leave m, l and acc exactly as they are;
//  * q, k and v are read in the model's (B, S, N, H) layout through strides,
//    and the KV head of query head n is n / G: KV is never replicated;
//  * S and T of any size: rows past S are not written, keys past T are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int H>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.qb + n * p.qn;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + nkv * p.kn;
  const T* v = static_cast<const T*>(p.v) + b * p.vb + nkv * p.vn;

  for (int i = tid; i < kBQ * H; i += kThreads) {
    const int r = i / H, h = i % H;
    const int qi = q0 + r;
    Qs[r * LD + h] = qi < p.S ? to_f32(q[qi * p.qs + h]) * p.scale : 0.f;
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
      Ks[r * LD + h] = in ? to_f32(k[kj * p.ks + h]) : 0.f;
      Vs[r * H + h] = in ? to_f32(v[kj * p.vs + h]) : 0.f;
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

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + tr + 16 * i;
    if (qi >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    const long long base = ((static_cast<long long>(b) * p.S + qi) * p.Nq + n) * H;
#pragma unroll
    for (int j = 0; j < kOut; ++j) o[base + tc + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + kBQ - 1) / kBQ, p.Nq, B);
  flash_fwd<T, H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_h(int H, const Params& p, int B, cudaStream_t stream) {
  switch (H) {
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, S|T, N, H) with unit stride over H and the element strides
// given; o: contiguous (B, S, Nq, H).  bf16 = 1 for bfloat16 inputs and
// output, 0 for float32.  Returns cudaGetLastError() after the launch.
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
  cudaError_t err = bf16 ? dispatch_h<__nv_bfloat16>(H, p, B, st) : dispatch_h<float>(H, p, B, st);
  return static_cast<int>(err);
}

}  // extern "C"
