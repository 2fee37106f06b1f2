// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/rglru_scan/kernel.py::_rglru_kernel of the
// JAX reference (launcher rglru_scan_kernel, wrapper ops.rglru_scan). Python
// side: repro_torch/kernels/rglru_scan/ (kernel.py binds these entry points,
// ops.py checks the arguments, ref.py is the plain PyTorch version this kernel
// is tested against).
//
// Computes, per batch row b and channel c, from h = 0:
//   y[b, t, c] = a[b, t, c] * y[b, t-1, c] + b[b, t, c],   t = 0 .. S-1
// with a and b (B, S, C) f32 or bf16, widened to f32 at load as the Pallas
// body does, and y (B, S, C) f32. The product and the sum are rounded
// separately (no fused multiply-add), as the plain version computes them.
//
// What bounds it on the card: memory. It reads a and b and writes y once,
// 3 * B * S * C * 4 bytes for f32 inputs, with two flops per element.
// What the design does about it: one thread per (b, c) walks t = 0 .. S-1
// with h in a register; neighbouring threads take neighbouring channels, so
// every load and store of a time step is one coalesced transaction per warp,
// and the loop is unrolled so the loads of several steps are in flight at
// once (they do not depend on h). Ragged S and C are masked here: the
// reference's identity padding (a = 1, b = 0) is not needed.
//
// Its weakness: only B * C threads exist (4,096 at recurrentgemma-9b's width
// and batch 1, 32 blocks on 132 SMs), each walking all of S in sequence, so
// few loads are in flight and the card's memory rate is far from reached. A
// chunked two-pass scan (per-chunk products and sums, then a carry pass)
// would put S / chunk times more threads to work: ROADMAP Queue 2 row 4.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      float* __restrict__ y, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int64_t base = (int64_t)blockIdx.y * S * C + c;
  float h = 0.f;
#pragma unroll 16
  for (int t = 0; t < S; ++t) {
    const int64_t i = base + (int64_t)t * C;
    h = __fadd_rn(__fmul_rn(to_float(a[i]), h), to_float(b[i]));
    y[i] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int C,
           void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(y), S, C);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b (B, S, C) contiguous, same dtype; y (B, S, C) f32 contiguous (checked
// by ops.py). Launches on `stream` and returns a CUDA error code (0 =
// launched).
extern "C" int rglru_scan_f32(const void* a, const void* b, void* y, int B,
                              int S, int C, void* stream) {
  return launch<float>(a, b, y, B, S, C, stream);
}

extern "C" int rglru_scan_bf16(const void* a, const void* b, void* y, int B,
                               int S, int C, void* stream) {
  return launch<__nv_bfloat16>(a, b, y, B, S, C, stream);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
