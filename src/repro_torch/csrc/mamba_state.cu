// The Mamba2 decode state step for Hopper (sm_90a): one token per slot over
// the paged serving layout's per-slot SSM state, updated in place.
//
// Replaces no TPU kernel: the reference's decode step is plain jnp
// (models/mamba2.py::ssd_decode_step). The port's paged decode
// (models/mamba2.py::mamba2_decode_paged) ran it as three PyTorch passes over
// the f32 state: a multiply by the decay, an addcmul of the update, and an
// f32 einsum for y, each reading the whole state (dead slots too) and the
// first two writing it. Python side: repro_torch/kernels/mamba_state/
// (kernel.py binds these entry points, ops.py checks the arguments, counts
// launches and picks this kernel or the plain version, ref.py holds the
// plain PyTorch version this kernel is tested against).
//
// Computes, for every live slot b (live[b] != 0), head h (group
// g = h / (H / G)), head channel p and state entry n, in f32:
//   h'[b,h,p,n] = exp(dt[b,h] A[h]) h[b,h,p,n] + (dt[b,h] x[b,h,p]) B[b,g,n]
//   y[b,h,p]    = sum_n C[b,g,n] h'[b,h,p,n]
// with the state h (B, H, P, N) f32 updated in place, dt (B, H) and A (H,)
// f32, x (B, H, P) and B, C (B, G, N) read in the served dtype (f32 or
// bf16) through their strides (in the served decode they are views of the
// conv's (B, conv_dim) output, which its einsum lays out slot-minor) and
// widened, and y (B, H, P) written in f32. A dead slot's state is neither
// read nor written; its y row is written as zeros. The product (dt x) B is
// fused into the add (fmaf), as PyTorch's CUDA addcmul contracts it (the
// card's h' equals the plain version's bit for bit at docqa's shape); y's
// sum runs in another order than the einsum's.
//
// What bounds it on the card: bytes. A live slot's state is read once and
// written once, H P N 4 B each way (4.2 MB at granite-4.0-h-small's 128
// heads of 64 x 128), against 2 flops an entry for the update and 2 for y:
// 0.5 flop a byte, far below the H100's ridge. At 64 live slots a layer
// moves 537 MB, 0.160 ms at 3.35 TB/s; the state (268 MB a layer, 9.7 GB
// over 36 layers) does not stay in the 50 MB L2 from one step to the next.
// What the design does:
//
// * one block per (slot, head), kWarps warps, the head's P rows in one
//   pass (P <= kRows kWarps 32 / (N / 4): 64 at N = 128, 256 at N = 32;
//   ops.py refuses more); a state row of N floats is split into 16-byte
//   float4 loads over N / 4 lanes, one a lane, so neighbouring lanes read
//   neighbouring addresses;
// * each thread issues all kRows of its 16-byte state loads before it uses
//   any (kRows x 16 B in flight a thread: 32 KB a block of 8 warps), with
//   the streaming hints (ld.global.cs / st.global.cs: evict first), since no
//   byte of the state is read again before the next step;
// * B and C of the group go to registers once a thread (the thread's four
//   entries of n), exp(dt A) and dt once a block, x once a row;
// * y's row sum: each lane sums its entries, then warp shuffles over the
//   lanes of the row (xor, log2(N / 4) steps), no shared memory, no
//   atomics: two calls on the same inputs give the same bits;
// * a dead slot's blocks read live[b] and exit after writing their zeros,
//   so the mask is read on the device and the launch, with no host
//   synchronisation and no scratch, is safe to capture in a CUDA graph.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py). kWarps and
// kRows are within 1% of the fastest of PERF.md's sweep at docqa's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;               // state rows of a thread, a 16-byte
                                       // load each

// The most rows a head may have at d_state N: one block covers them all.
constexpr int max_rows(int n) { return kRows * kWarps * (32 / (n / 4)); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  float* ssm;                 // (B, H, P, N) f32, contiguous
  const void* x;              // (B, H, P), strides sxb, sxh, sxp
  const float* dt;            // (B, H) f32, contiguous
  const float* A;             // (H,) f32
  const void* B;              // (B, G, N), strides sbb, sbg, sbn
  const void* C;              // (B, G, N), strides scb, scg, scn
  const uint8_t* live;        // (B,) bool
  float* y;                   // (B, H, P) f32, contiguous
  int H, P, rep;              // rep = H / G
  long long sxb, sxh, sxp, sbb, sbg, sbn, scb, scg, scn;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) mamba_state_step(Args a) {
  constexpr int kLanes = N / 4;                   // lanes of a row, a
                                                  // float4 each
  constexpr int kStride = kWarps * (32 / kLanes); // rows between a
                                                  // thread's rows
  static_assert(N == 32 || N == 128, "N must be 32 or 128");

  const int bh = blockIdx.x;                      // b * H + h
  const int b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane % kLanes;
  const int row0 = warp * (32 / kLanes) + lane / kLanes;
  float* yrow = a.y + static_cast<size_t>(bh) * a.P;

  if (!a.live[b]) {
    if (col == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = row0 + k * kStride;
        if (r < a.P) yrow[r] = 0.0f;
      }
    }
    return;
  }

  float4* st = reinterpret_cast<float4*>(a.ssm)
               + static_cast<size_t>(bh) * a.P * kLanes + col;
  float4 hv[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = row0 + k * kStride;
    if (r < a.P) hv[k] = __ldcs(st + static_cast<size_t>(r) * kLanes);
  }

  const float dt = a.dt[bh];
  const float decay = expf(dt * a.A[h]);
  const int g = h / a.rep;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sbb + g * a.sbg;
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb + g * a.scg;
  const T* xr = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  float bv[4], cv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = col * 4 + i;
    bv[i] = widen(Bg[n * a.sbn]);
    cv[i] = widen(Cg[n * a.scn]);
  }

  float part[kRows];                // each row's share of this lane in y
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = row0 + k * kStride;
    part[k] = 0.0f;
    if (r >= a.P) continue;
    const float xdt = dt * widen(xr[r * a.sxp]);
    float4 s = hv[k];
    s.x = fmaf(xdt, bv[0], decay * s.x);
    s.y = fmaf(xdt, bv[1], decay * s.y);
    s.z = fmaf(xdt, bv[2], decay * s.z);
    s.w = fmaf(xdt, bv[3], decay * s.w);
    __stcs(st + static_cast<size_t>(r) * kLanes, s);
    float acc = cv[0] * s.x;
    acc = fmaf(cv[1], s.y, acc);
    acc = fmaf(cv[2], s.z, acc);
    part[k] = fmaf(cv[3], s.w, acc);
  }
  // every lane of a row holds the same rows, so the shuffles stay within
  // the row's kLanes lanes and no lane is left out of a sync
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    float acc = part[k];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int r = row0 + k * kStride;
    if (col == 0 && r < a.P) yrow[r] = acc;
  }
}

template <typename T, int N>
int launch(const Args& a, int batch, cudaStream_t s) {
  if (a.P > max_rows(N)) return static_cast<int>(cudaErrorInvalidValue);
  mamba_state_step<T, N><<<batch * a.H, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int step(void* ssm, const void* x, const void* dt, const void* A,
         const void* B, const void* C, const void* live, void* y, int batch,
         int H, int P, int N, int G, long long sxb, long long sxh,
         long long sxp, long long sbb, long long sbg, long long sbn,
         long long scb, long long scg, long long scn, void* stream) {
  if (batch < 1 || H < 1 || P < 1 || G < 1 || H % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<float*>(ssm), x, static_cast<const float*>(dt),
               static_cast<const float*>(A), B, C,
               static_cast<const uint8_t*>(live), static_cast<float*>(y),
               H, P, H / G, sxb, sxh, sxp, sbb, sbg, sbn, scb, scg, scn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 32: return launch<T, 32>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ssm (batch, H, P, N) f32, contiguous and 16-byte aligned, updated in
// place; x (batch, H, P), B and C (batch, G, N) in the entry point's dtype
// with the strides given (in elements); dt (batch, H) and A (H,) f32,
// contiguous; live (batch,) bool; y (batch, H, P) f32, contiguous. N 128
// with P <= 64, or N 32 with P <= 256 (checked by ops.py, and again here).
// Launches on `stream` and returns a CUDA error code (0 = launched).
#define MAMBA_STATE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(void* ssm, const void* x, const void* dt,             \
                      const void* A, const void* B, const void* C,          \
                      const void* live, void* y, int batch, int H, int P,   \
                      int N, int G, long long sxb, long long sxh,           \
                      long long sxp, long long sbb, long long sbg,          \
                      long long sbn, long long scb, long long scg,          \
                      long long scn, void* stream) {                        \
    return step<T>(ssm, x, dt, A, B, C, live, y, batch, H, P, N, G, sxb,    \
                   sxh, sxp, sbb, sbg, sbn, scb, scg, scn, stream);         \
  }

MAMBA_STATE_ENTRY(mamba_state_f32, float)
MAMBA_STATE_ENTRY(mamba_state_bf16, __nv_bfloat16)

extern "C" const char* mamba_state_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
