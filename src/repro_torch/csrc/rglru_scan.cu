// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/rglru_scan/kernel.py::_rglru_kernel of the
// JAX reference (launcher rglru_scan_kernel, wrapper ops.rglru_scan). Python
// side: repro_torch/kernels/rglru_scan/ (kernel.py binds these entry points,
// ops.py checks the arguments, ref.py holds the plain PyTorch version this
// kernel is tested against and a plain model of its chunked scan).
//
// Computes, per batch row b and channel c, from h = 0:
//   y[b, t, c] = a[b, t, c] * y[b, t-1, c] + b[b, t, c],   t = 0 .. S-1
// with a and b (B, S, C) f32 or bf16, widened to f32 at load as the Pallas
// body does, and y (B, S, C) f32. The product and the sum are rounded
// separately (no fused multiply-add), as the plain version computes them.
//
// What bounds it on the card: memory. It reads a and b and writes y once,
// 3 * B * S * C * 4 bytes for f32 inputs (125.8 MB at recurrentgemma-9b's
// (1, 2560, 4096), 0.0376 ms at 3.35 TB/s), with two flops per element.
//
// What the design does about it: a chunked scan in one pass over memory.
// A tile is T time steps (T in {32, 64, 128}, ops.py's CHUNK, from the sweep
// in PERF.md) by 128 channels, one block of 128 threads, a thread per
// channel, so (1, 2560, 4096) at T = 64 gives 40 x 32 = 1,280 blocks where
// the first design ran 32. Each block
//   1. takes its tile from an atomic ticket, chunk index slowest, so a block
//      waits only on blocks that took their tickets before it (and so are
//      running): no deadlock, whatever order the card schedules blocks in;
//   2. stages its a and b columns in shared memory: each thread copies its
//      channel's T steps (a warp's copies of one step are one coalesced
//      128-byte row), for f32 all of them in flight at once by 4-byte
//      cp.async (1.23x faster than 16 loads in flight at T = 64 on an
//      H100 80GB HBM3: PERF.md); every byte is read from device memory
//      once;
//   3. computes its tile's aggregate per channel, (prod a, the end value
//      from h = 0), and publishes it with a ready flag (release);
//   4. waits for the flags of every earlier chunk of its channel tile
//      (acquire) and folds their aggregates in chunk order into its carry:
//      the order is fixed, so the result is the same bits in every call (a
//      look-back that stopped at whichever inclusive prefix happened to be
//      ready would not be);
//   5. scans its tile from the carry out of shared memory and writes y.
// The flags and the ticket are zeroed by a memset on the same stream in
// every call (so a replayed CUDA graph zeroes them too); the aggregates,
// under 1 MB, are scratch the wrapper allocates. Ragged S and C are masked
// here: the reference's identity padding (a = 1, b = 0) is not needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCh = 128;  // channels of a tile = threads of a block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// h' = a h + b, the product and the sum rounded separately
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// flags: n_tiles ready flags, then the ticket (all 0 at launch); agg:
// n_tiles x kCh (prod a, end value from 0). Tile (b, ct, c) has index
// (b * nct + ct) * nc + c.
template <typename T, int kT>
__global__ void __launch_bounds__(kCh)
    rglru_scan_chunks(const T* __restrict__ a, const T* __restrict__ b,
                     float* __restrict__ y, float2* __restrict__ agg,
                     int* __restrict__ flags, int B, int S, int C, int nct,
                     int nc) {
  extern __shared__ float smem[];
  float* as = smem;            // [kT][kCh]
  float* bs = smem + kT * kCh;  // [kT][kCh]
  __shared__ int ticket;

  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(flags + B * nct * nc, 1);
  __syncthreads();
  const int per_chunk = B * nct;
  const int c = ticket / per_chunk;
  const int bb = (ticket % per_chunk) / nct;
  const int ct = ticket % nct;
  const int ch = ct * kCh + tid;
  const bool live = ch < C;
  const int t0 = c * kT;
  const int steps = min(kT, S - t0);
  const int64_t base = ((int64_t)bb * S + t0) * C + ch;
  const int64_t first = ((int64_t)bb * nct + ct) * nc;  // chunk 0's tile

  // stage this channel's column (only this thread reads it back): f32 by
  // 4-byte cp.async, every copy of the tile in flight at once; bf16 by
  // loads widened to f32, 16 steps in flight
  if (live) {
    if constexpr (sizeof(T) == 4) {
      for (int t = 0; t < steps; ++t) {
        cp_async4(as + t * kCh + tid, a + base + (int64_t)t * C);
        cp_async4(bs + t * kCh + tid, b + base + (int64_t)t * C);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
#pragma unroll 16
      for (int t = 0; t < kT; ++t) {
        if (t < steps) {
          as[t * kCh + tid] = to_float(a[base + (int64_t)t * C]);
          bs[t * kCh + tid] = to_float(b[base + (int64_t)t * C]);
        }
      }
    }
  }

  // the tile's aggregate, published unless no later chunk reads it
  if (c + 1 < nc) {
    if (live) {
      float pa = 1.f, h = 0.f;
      for (int t = 0; t < steps; ++t) {
        pa = __fmul_rn(pa, as[t * kCh + tid]);
        h = step(as[t * kCh + tid], h, bs[t * kCh + tid]);
      }
      agg[(first + c) * kCh + tid] = make_float2(pa, h);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flags + first + c, 1);
  }

  // the carry: every earlier chunk's aggregate, folded in chunk order
  for (int k = tid; k < c; k += kCh)
    while (load_acquire(flags + first + k) == 0) {
    }
  __syncthreads();
  if (!live) return;
  float h = 0.f;
#pragma unroll 8
  for (int k = 0; k < c; ++k) {
    const float2 g = __ldcg(agg + (first + k) * kCh + tid);
    h = step(g.x, h, g.y);
  }

  // the tile's scan from the carry
  for (int t = 0; t < steps; ++t) {
    h = step(as[t * kCh + tid], h, bs[t * kCh + tid]);
    y[base + (int64_t)t * C] = h;
  }
}

template <typename T, int kT>
int launch_chunk(const void* a, const void* b, void* y, void* agg,
                 void* flags, int B, int S, int C, int nct, int nc,
                 cudaStream_t stream) {
  const size_t smem = (size_t)2 * kT * kCh * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_scan_chunks<T, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rglru_scan_chunks<T, kT><<<B * nct * nc, kCh, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<float*>(y), static_cast<float2*>(agg),
      static_cast<int*>(flags), B, S, C, nct, nc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, void* y, void* agg, void* flags,
           int B, int S, int C, int chunk, void* stream) {
  if (B < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nct = (C + kCh - 1) / kCh;
  const int nc = (S + chunk - 1) / chunk;
  const cudaError_t e =
      cudaMemsetAsync(flags, 0, ((size_t)B * nct * nc + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  switch (chunk) {
    case 32:
      return launch_chunk<T, 32>(a, b, y, agg, flags, B, S, C, nct, nc, s);
    case 64:
      return launch_chunk<T, 64>(a, b, y, agg, flags, B, S, C, nct, nc, s);
    case 128:
      return launch_chunk<T, 128>(a, b, y, agg, flags, B, S, C, nct, nc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a, b (B, S, C) contiguous, same dtype; y (B, S, C) f32 contiguous (checked
// by ops.py); chunk in {32, 64, 128} time steps. Scratch, with nct =
// ceil(C / 128) and nc = ceil(S / chunk): agg (B * nct * nc * 128) float2 and
// flags (B * nct * nc + 1) int32, zeroed here. Launches a memset and the
// kernel on `stream` and returns a CUDA error code (0 = launched).
extern "C" int rglru_scan_f32(const void* a, const void* b, void* y,
                              void* agg, void* flags, int B, int S, int C,
                              int chunk, void* stream) {
  return launch<float>(a, b, y, agg, flags, B, S, C, chunk, stream);
}

extern "C" int rglru_scan_bf16(const void* a, const void* b, void* y,
                               void* agg, void* flags, int B, int S, int C,
                               int chunk, void* stream) {
  return launch<__nv_bfloat16>(a, b, y, agg, flags, B, S, C, chunk, stream);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
