// Hopper (sm_90a) RG-LRU linear recurrence, hand-written in CUDA C++ and
// bound through a plain C interface (ctypes, see ../cuda.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru/kernel.py:46
// rg_lru_call (_lru_kernel :29): h_t = exp(log_a_t) * h_{t-1} + x_t with
// h_0 = 0, elementwise over the width, (B, S, W) f32 in, f32 out.
//
// What bounds it: bytes.  Each element is read twice (log_a, x: 8 bytes) and
// written once (y: 4 bytes) for an exp, a multiply and an add: at B 4,
// S 4096, W 4096 that is 805 MB, 0.24 ms at 3.35 TB/s.
//
// Design: one thread per (batch, width) column walks time sequentially, the
// reference's form (kernel.py:10-14: an associative scan would lose
// exactness through cumprod underflow).  Neighbouring threads take
// neighbouring widths, so every load of log_a_t and x_t and every store of
// y_t is coalesced.  With only B * W columns (16,384 at the shape above)
// there are few threads to hide memory latency, so each thread loads 16 time
// steps at once and loads the next 16 before it computes the current ones:
// up to 32 steps of both inputs are in flight per thread.  The multiply and
// the add are rounded separately (__fmul_rn, __fadd_rn), as the plain
// version computes them, so nvcc cannot contract them into an FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float step(float h, float la, float x) {
  return __fadd_rn(__fmul_rn(expf(la), h), x);
}

__global__ void __launch_bounds__(kThreads)
    rg_lru_fwd(const float* __restrict__ log_a, const float* __restrict__ x,
               float* __restrict__ y, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + w;
  const float* la_p = log_a + base;
  const float* x_p = x + base;
  float* y_p = y + base;
  const int s_main = S - S % kUnroll;

  float h = 0.f;
  float la[kUnroll], xv[kUnroll];
  if (s_main > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la[u] = __ldg(la_p + static_cast<long long>(u) * W);
      xv[u] = __ldg(x_p + static_cast<long long>(u) * W);
    }
  }
  for (int t = 0; t < s_main; t += kUnroll) {
    float la_n[kUnroll], x_n[kUnroll];
    const int tn = t + kUnroll;
    if (tn < s_main) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        la_n[u] = __ldg(la_p + static_cast<long long>(tn + u) * W);
        x_n[u] = __ldg(x_p + static_cast<long long>(tn + u) * W);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = step(h, la[u], xv[u]);
      y_p[static_cast<long long>(t + u) * W] = h;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      la[u] = la_n[u];
      xv[u] = x_n[u];
    }
  }
  for (int t = s_main; t < S; ++t) {
    const long long i = static_cast<long long>(t) * W;
    h = step(h, __ldg(la_p + i), __ldg(x_p + i));
    y_p[i] = h;
  }
}

}  // namespace

extern "C" {

// log_a, x, y: contiguous (B, S, W) float32.  Returns cudaGetLastError()
// after the launch.
int rg_lru_forward(const float* log_a, const float* x, float* y, int B, int S, int W,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + kThreads - 1) / kThreads, B);
  rg_lru_fwd<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(log_a, x, y, S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
