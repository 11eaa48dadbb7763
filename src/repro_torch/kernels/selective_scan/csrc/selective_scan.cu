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
// Design (not the TPU's tiling, which walks time chunks of a channel block in
// order with h in VMEM): one thread owns one (b, d) channel for the whole
// sequence and keeps its N states in registers, so dA and dBu are formed on
// the fly and never stored.  B_t and C_t are the same for every channel of
// batch row b: the block stages them for kTC steps at a time in shared
// memory, double-buffered, one barrier per chunk.  Neighbouring channels take
// neighbouring threads, so delta_t and u_t load coalesced; each thread loads
// the next kTC steps of both before it computes the current ones.  A state
// beyond N gets A = B = C = 0 and a step beyond S gets delta = B = 0: both
// leave h and y unchanged, so any S, D and N <= 16 run without padding.
// Measured slower on an H100 (PERF.md): splitting a channel's states over 2
// or 4 lanes (more threads, a shuffle for y), exp2f or __expf in place of
// expf, a pairwise sum for y, chunks of 8 or 32 steps, blocks of 64 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTC = 16;        // time steps per staged chunk
constexpr int kN = 16;         // states held per channel (Mamba-1's N)

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// One thread per (b, d) channel, its kN >= N states in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ss_fwd(const T* __restrict__ u, const float* __restrict__ delta,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ hT,
           int S, int D, int N) {
  constexpr int kChunk = kTC * kN;  // B (or C) values per staged chunk
  constexpr int kStage = 2 * kChunk / kThreads;
  static_assert(2 * kChunk % kThreads == 0, "a chunk of B and C must split evenly");
  __shared__ float sbc[2][2][kTC][kN];  // [buffer][B, C][step][state]

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;
  const int dc = active ? d : D - 1;  // the ragged edge computes a real channel, stores nothing
  const long long row = static_cast<long long>(b) * S;
  const T* u_p = u + row * D + dc;
  const float* dl_p = delta + row * D + dc;
  const float* b_p = Bm + row * N;
  const float* c_p = Cm + row * N;

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = n < N ? __ldg(A + static_cast<long long>(dc) * N + n) : 0.f;
    h[n] = 0.f;
  }

  auto load_du = [&](int t0, float (&dl)[kTC], float (&uv)[kTC]) {
#pragma unroll
    for (int k = 0; k < kTC; ++k) {
      const long long i = static_cast<long long>(t0 + k) * D;
      const bool in = t0 + k < S;
      dl[k] = in ? __ldg(dl_p + i) : 0.f;
      uv[k] = in ? load_f32(u_p + i) : 0.f;
    }
  };
  // B and C of one chunk, flattened as sbc[buffer]: [B, C][step][state].
  auto load_bc = [&](int t0, float (&st)[kStage]) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int r = i % kChunk, t = t0 + r / kN, n = r % kN;
      const float* src = i < kChunk ? b_p : c_p;
      st[j] = (t < S && n < N) ? __ldg(src + static_cast<long long>(t) * N + n) : 0.f;
    }
  };
  auto store_bc = [&](int buf, const float (&st)[kStage]) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) (&sbc[buf][0][0][0])[threadIdx.x + j * kThreads] = st[j];
  };

  float dl[kTC], uv[kTC], st[kStage];
  load_du(0, dl, uv);
  load_bc(0, st);
  store_bc(0, st);
  __syncthreads();

  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kTC) {
    const bool more = t0 + kTC < S;
    float dl_n[kTC], u_n[kTC];
    if (more) {  // the next chunk's loads go out before this chunk's work
      load_du(t0 + kTC, dl_n, u_n);
      load_bc(t0 + kTC, st);
    }
#pragma unroll
    for (int k = 0; k < kTC; ++k) {
      const float dt = dl[k];
      const float du = dt * uv[k];
      float yk = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = expf(dt * a[n]) * h[n] + du * sbc[buf][0][k][n];
        yk += h[n] * sbc[buf][1][k][n];
      }
      if (active && t0 + k < S) y[(row + t0 + k) * D + d] = yk;
    }
    if (more) store_bc(buf ^ 1, st);
    __syncthreads();
    buf ^= 1;
    if (more) {
#pragma unroll
      for (int k = 0; k < kTC; ++k) {
        dl[k] = dl_n[k];
        uv[k] = u_n[k];
      }
    }
  }

  if (active) {
    float* h_p = hT + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (n < N) h_p[n] = h[n];
    }
  }
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
  if (B > 65535 || N < 1 || N > kN) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_bf16)
    ss_fwd<<<grid, kThreads, 0, st>>>(static_cast<const __nv_bfloat16*>(u), delta, A, Bm, Cm, y,
                                      hT, S, D, N);
  else
    ss_fwd<<<grid, kThreads, 0, st>>>(static_cast<const float*>(u), delta, A, Bm, Cm, y, hT, S,
                                      D, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
