// The routed experts of a token-choice MoE FFN as a grouped product over the
// live (token, expert) entries, for Hopper (sm_90a): the decode's dispatch
// groups, where no entry can be dropped (capacity C >= the group length S).
//
// Replaces no TPU kernel: the reference's expert products are `jnp.einsum`
// over a GShard (B, E, C, d) buffer, outside any Pallas kernel. The port's
// buffer path (models/moe.py::_experts) still runs wherever C < S. Python
// side: repro_torch/kernels/moe_experts/ (kernel.py binds these entry
// points, ops.py checks the arguments and counts launches, ref.py holds the
// plain PyTorch version this kernel is tested against).
//
// Computes, for the N = T * K entries of T tokens routed to K experts each
// (entry i is token i / K's choice flat_e[i]) and the n experts held here
// (first .. first + n - 1; an entry of another expert adds zero):
//   y[i] = (silu(x[i / K] Wg[e]) * (x[i / K] Wu[e])) Wd[e]
// with e = flat_e[i] - first and f32 sums. In bf16 g = x Wg and u = x Wu are
// rounded to bf16, silu(g) is rounded, and so is the product h: each step
// rounds as the buffer path's PyTorch ops do.
//
// What bounds it on the card: the held experts' weight bytes. At a decode
// step's 64 rows nearly every held expert is chosen, so each layer must read
// all of their three matrices (3 n d ff elements) for 64 K rows of work:
// about K * 64 / n rows an expert, far below the H100's ridge. The buffer
// path ran every expert over C = K slots of every row (97.5% of them empty
// at granite-moe-3b's decode) and moved a zero-filled buffer there and back.
// What the design does:
//
// * moe_dispatch, one block: a stable counting sort of the entries by
//   expert (entries of experts not held last), with fixed shapes and no
//   host synchronisation: counts by shared-memory atomics, their exclusive
//   scan (offsets[k], k = 0 .. n, offsets[n + 1] = N), then each entry's
//   rank among the earlier entries of its expert from __match_any_sync
//   within a warp and per-warp counts across warps, in entry order, so
//   perm[offsets[e] + r] = the r-th entry of expert e. It lets the next
//   launch start at once (griddepcontrol.launch_dependents).
// * gate/up: a grid of (ff tile of 64, held expert) blocks of 4 warps. A
//   block streams its tile of Wg[e] and Wu[e] from device memory once,
//   64 rows of d a stage through 4 cp.async stages in shared memory; the
//   first 3 stages go out before the block waits for the dispatch
//   (griddepcontrol.wait), whose rows it then needs. It gathers its
//   expert's x rows through perm (at most 64 a pass; more rows take
//   another pass over the tile) and runs mma.sync m16n8k16 with f32 sums:
//   every M tile of 16 rows reuses the weight tile in shared memory. The
//   epilogue writes h = silu(g) * u, in the sorted order, to a (N, ff)
//   scratch. An expert with no rows exits at once.
// * down: a grid of (d tile of 128, held expert + 1) blocks, the same
//   pipeline over Wd[e]'s tile (ff deep) and the expert's h rows, which
//   writes each row of y to its entry (perm). The extra expert index
//   writes zeros to the rows of the entries whose expert is not held.
// Each launch is a programmatic dependent launch of the one before. There
// are no atomics in any sum: the output is bitwise the same on every call.
//
// f32 (the card tests, TF32 off): the same grids on the CUDA cores, one
// thread per output column, sums in k order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;  // cp.async, ldmatrix, mma.sync (mma_sm90.cuh)

constexpr int kThreads = 128;         // 4 warps
constexpr int kRows = 64;             // rows of one pass over a weight tile
constexpr int kMT = kRows / 16;       // its M tiles
constexpr int kBK = 64;               // reduction depth of a stage
constexpr int kStages = 4;
constexpr int kTF = 64;               // gate/up: ff columns of a block
constexpr int kTN = 128;              // down: d columns of a block
constexpr int kPad = 8;               // row padding: conflict-free ldmatrix
constexpr int kXS = kBK + kPad;       // row stride of an x or h tile
constexpr int kGS = kTF + kPad;       // of a Wg / Wu tile
constexpr int kDS = kTN + kPad;       // of a Wd tile
constexpr int kDispatchThreads = 1024;
constexpr int kDispatchWarps = kDispatchThreads / 32;
constexpr int kMaxKeys = 257;         // held experts + 1 (not held)
constexpr int kMaxDevices = 64;

constexpr size_t kGateUpSmem =
    sizeof(bf16) * kStages * (kRows * kXS + 2 * kBK * kGS);
constexpr size_t kDownSmem = sizeof(bf16) * kStages * (kRows * kXS + kBK * kDS);

// SiLU, the only activation of the port's MoE configs (ops.py refuses any
// other), as PyTorch's CUDA silu computes it (in f32)
__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// programmatic dependent launch: let the next launch be scheduled now; wait
// until the previous one has finished and its writes are visible
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ int key_of(int64_t e, int first, int n) {
  return (e >= first && e < first + n) ? static_cast<int>(e - first) : n;
}

// ---------------------------------------------------------------- dispatch

__global__ void __launch_bounds__(kDispatchThreads)
    moe_dispatch_sort(const int64_t* __restrict__ flat_e, int N, int first,
                      int n, int* __restrict__ perm,
                      int* __restrict__ offsets) {
  launch_dependents();
  __shared__ int start[kMaxKeys];
  __shared__ int wcount[kDispatchWarps][kMaxKeys];
  const int keys = n + 1, tid = threadIdx.x, lane = tid % 32,
            warp = tid / 32;
  for (int k = tid; k < keys; k += kDispatchThreads) start[k] = 0;
  __syncthreads();
  for (int i = tid; i < N; i += kDispatchThreads)
    atomicAdd(&start[key_of(flat_e[i], first, n)], 1);
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int k = 0; k < keys; ++k) {
      const int c = start[k];
      start[k] = offsets[k] = run;
      run += c;
    }
    offsets[keys] = run;
  }
  // stable ranks, a block of entries at a time: start[k] runs on to the
  // next free position of key k
  for (int base = 0; base < N; base += kDispatchThreads) {
    for (int j = tid; j < kDispatchWarps * keys; j += kDispatchThreads)
      wcount[j / keys][j % keys] = 0;
    __syncthreads();
    const int i = base + tid;
    const bool valid = i < N;
    const int key = valid ? key_of(flat_e[i], first, n) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int below = __popc(peers & ((1u << lane) - 1u));
    if (valid && below == 0) wcount[warp][key] = __popc(peers);
    __syncthreads();
    for (int k = tid; k < keys; k += kDispatchThreads) {
      int run = start[k];
      for (int w = 0; w < kDispatchWarps; ++w) {
        const int c = wcount[w][k];
        wcount[w][k] = run;
        run += c;
      }
      start[k] = run;
    }
    __syncthreads();
    if (valid) perm[wcount[warp][key] + below] = i;
    __syncthreads();
  }
}

template <typename T>
struct Args {
  const T* x;            // (T, d)
  const int* perm;       // (N,)
  const int* offsets;    // (n + 2,)
  const T* wg;           // (n, d, ff)
  const T* wu;           // (n, d, ff)
  const T* wd;           // (n, ff, d)
  T* h;                  // (N, ff) scratch, sorted order
  T* y;                  // (N, d), entry order
  int N, top_k, d, ff, n;
};

// ------------------------------------------------ bf16: tensor cores

// gate/up: block (ff tile, held expert)
__global__ void __launch_bounds__(kThreads, 2)
    moe_experts_gate_up(const Args<bf16> a) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);     // [stage][row][k]
  bf16* gs = xs + kStages * kRows * kXS;            // [stage][k][f]
  bf16* us = gs + kStages * kBK * kGS;
  __shared__ int tok[kRows];
  const int e = blockIdx.y, f0 = blockIdx.x * kTF;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t wbase = static_cast<size_t>(e) * a.d * a.ff + f0;
  const bf16* wg = a.wg + wbase;
  const bf16* wu = a.wu + wbase;
  const int KT = a.d / kBK;

  auto load_w = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kBK;
    for (int c = tid; c < kBK * (kTF / 8); c += kThreads) {
      const int r = c / (kTF / 8), col = (c % (kTF / 8)) * 8;
      const size_t src = static_cast<size_t>(k0 + r) * a.ff + col;
      const int dst = (s * kBK + r) * kGS + col;
      cp_async16(smem_addr(gs + dst), wg + src, true);
      cp_async16(smem_addr(us + dst), wu + src, true);
    }
  };
  auto load_x = [&](int kt, int rows) {
    const int s = kt % kStages, k0 = kt * kBK;
    const int lim = (rows + 15) / 16 * 16;
    for (int c = tid; c < lim * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const bool ok = r < rows;
      const bf16* src =
          a.x + (ok ? static_cast<size_t>(tok[r]) * a.d + k0 + col : 0);
      cp_async16(smem_addr(xs + (s * kRows + r) * kXS + col), src, ok);
    }
  };

  // the first stages' weights go out before the dispatch is waited for
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_w(s);
    cp_async_commit();
  }
  wait_for_previous();
  const int r0 = a.offsets[e], m = a.offsets[e + 1] - r0;
  for (int c0 = 0; c0 < m; c0 += kRows) {
    const int rows = min(kRows, m - c0), mt = (rows + 15) / 16;
    __syncthreads();  // the previous pass is done with tok and the tiles
    for (int r = tid; r < rows; r += kThreads)
      tok[r] = a.perm[r0 + c0 + r] / a.top_k;
    __syncthreads();
    if (c0 > 0) {
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < KT) load_w(s);
        cp_async_commit();
      }
    }
    for (int s = 0; s < kStages - 1 && s < KT; ++s) load_x(s, rows);
    cp_async_commit();

    float g[kMT][2][4] = {}, u[kMT][2][4] = {};
    for (int kt = 0; kt < KT; ++kt) {
      if (kt == 0) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<kStages - 2>();
      }
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < KT) {
        load_w(next);
        load_x(next, rows);
      }
      cp_async_commit();
      const int s = kt % kStages;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t bg[4], bu[4];
        const int boff = (s * kBK + kk * 16) * kGS + warp * 16 +
                         b_lane_kn(lane, kGS);
        ldmatrix_x4_trans(smem_addr(gs + boff), bg);
        ldmatrix_x4_trans(smem_addr(us + boff), bu);
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          if (t < mt) {
            uint32_t af[4];
            ldmatrix_x4(smem_addr(xs + (s * kRows + t * 16) * kXS + kk * 16 +
                                  a_lane(lane, kXS)),
                        af);
            mma_16816(g[t][0], af, bg[0], bg[1]);
            mma_16816(g[t][1], af, bg[2], bg[3]);
            mma_16816(u[t][0], af, bu[0], bu[1]);
            mma_16816(u[t][1], af, bu[2], bu[3]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMT; ++t) {
      if (t >= mt) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t * 16 + lane / 4 + half * 8;
          if (row >= rows) continue;
          float hv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gv = round_bf16(g[t][j][2 * half + q]);
            const float uv = round_bf16(u[t][j][2 * half + q]);
            hv[q] = round_bf16(silu(gv)) * uv;
          }
          const int col = f0 + warp * 16 + j * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(
              a.h + static_cast<size_t>(r0 + c0 + row) * a.ff + col) =
              __floats2bfloat162_rn(hv[0], hv[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// the rows of entries whose expert is not held: zeros over the block's
// d columns
template <typename T>
__device__ void zero_unheld(const Args<T>& a, int n0, int width) {
  const int lo = a.offsets[a.n], per = width * static_cast<int>(sizeof(T)) / 16;
  for (int c = threadIdx.x; c < (a.N - lo) * per; c += kThreads) {
    const int r = lo + c / per, col = n0 + (c % per) * (16 / sizeof(T));
    *reinterpret_cast<uint4*>(a.y + static_cast<size_t>(a.perm[r]) * a.d +
                              col) = make_uint4(0, 0, 0, 0);
  }
}

// down: block (d tile, held expert or the not-held rows)
__global__ void __launch_bounds__(kThreads, 2)
    moe_experts_down(const Args<bf16> a) {
  launch_dependents();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hs = reinterpret_cast<bf16*>(smem_raw);     // [stage][row][k]
  bf16* ds = hs + kStages * kRows * kXS;            // [stage][k][n]
  __shared__ int dst[kRows];
  const int e = blockIdx.y, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (e == a.n) {
    wait_for_previous();
    zero_unheld(a, n0, kTN);
    return;
  }
  const bf16* wd = a.wd + static_cast<size_t>(e) * a.ff * a.d + n0;
  const int KT = a.ff / kBK;

  auto load_w = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kBK;
    for (int c = tid; c < kBK * (kTN / 8); c += kThreads) {
      const int r = c / (kTN / 8), col = (c % (kTN / 8)) * 8;
      cp_async16(smem_addr(ds + (s * kBK + r) * kDS + col),
                 wd + static_cast<size_t>(k0 + r) * a.d + col, true);
    }
  };
  int hrow0 = 0;
  auto load_h = [&](int kt, int rows) {
    const int s = kt % kStages, k0 = kt * kBK;
    const int lim = (rows + 15) / 16 * 16;
    for (int c = tid; c < lim * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const bool ok = r < rows;
      const bf16* src =
          a.h + (ok ? static_cast<size_t>(hrow0 + r) * a.ff + k0 + col : 0);
      cp_async16(smem_addr(hs + (s * kRows + r) * kXS + col), src, ok);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_w(s);
    cp_async_commit();
  }
  wait_for_previous();
  const int r0 = a.offsets[e], m = a.offsets[e + 1] - r0;
  for (int c0 = 0; c0 < m; c0 += kRows) {
    const int rows = min(kRows, m - c0), mt = (rows + 15) / 16;
    hrow0 = r0 + c0;
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) dst[r] = a.perm[hrow0 + r];
    if (c0 > 0) {
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < KT) load_w(s);
        cp_async_commit();
      }
    }
    for (int s = 0; s < kStages - 1 && s < KT; ++s) load_h(s, rows);
    cp_async_commit();

    float acc[kMT][4][4] = {};
    for (int kt = 0; kt < KT; ++kt) {
      if (kt == 0) {
        cp_async_wait<0>();
      } else {
        cp_async_wait<kStages - 2>();
      }
      __syncthreads();
      const int next = kt + kStages - 1;
      if (next < KT) {
        load_w(next);
        load_h(next, rows);
      }
      cp_async_commit();
      const int s = kt % kStages;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4_trans(smem_addr(ds + (s * kBK + kk * 16) * kDS +
                                      warp * 32 + p * 16 +
                                      b_lane_kn(lane, kDS)),
                            b[p]);
#pragma unroll
        for (int t = 0; t < kMT; ++t) {
          if (t < mt) {
            uint32_t af[4];
            ldmatrix_x4(smem_addr(hs + (s * kRows + t * 16) * kXS + kk * 16 +
                                  a_lane(lane, kXS)),
                        af);
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              mma_16816(acc[t][2 * p], af, b[p][0], b[p][1]);
              mma_16816(acc[t][2 * p + 1], af, b[p][2], b[p][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kMT; ++t) {
      if (t >= mt) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t * 16 + lane / 4 + half * 8;
          if (row >= rows) continue;
          const int col = n0 + warp * 32 + j * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + static_cast<size_t>(dst[row]) * a.d + col) =
              __floats2bfloat162_rn(acc[t][j][2 * half],
                                    acc[t][j][2 * half + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------ f32: CUDA cores

// gate/up: block (ff tile, held expert), thread = (column, row parity)
__global__ void __launch_bounds__(kThreads)
    moe_experts_gate_up_f32(const Args<float> a) {
  launch_dependents();
  wait_for_previous();
  const int e = blockIdx.y, f = blockIdx.x * kTF + threadIdx.x % kTF;
  const int r0 = a.offsets[e], m = a.offsets[e + 1] - r0;
  const float* wg = a.wg + static_cast<size_t>(e) * a.d * a.ff + f;
  const float* wu = a.wu + static_cast<size_t>(e) * a.d * a.ff + f;
  for (int r = threadIdx.x / kTF; r < m; r += kThreads / kTF) {
    const float* xr =
        a.x + static_cast<size_t>(a.perm[r0 + r] / a.top_k) * a.d;
    float g = 0.0f, u = 0.0f;
    for (int k = 0; k < a.d; ++k) {
      g = fmaf(xr[k], wg[static_cast<size_t>(k) * a.ff], g);
      u = fmaf(xr[k], wu[static_cast<size_t>(k) * a.ff], u);
    }
    a.h[static_cast<size_t>(r0 + r) * a.ff + f] = silu(g) * u;
  }
}

// down: block (d tile, held expert or the not-held rows), thread = column
__global__ void __launch_bounds__(kThreads)
    moe_experts_down_f32(const Args<float> a) {
  launch_dependents();
  wait_for_previous();
  const int e = blockIdx.y, n0 = blockIdx.x * kTN;
  if (e == a.n) {
    zero_unheld(a, n0, kTN);
    return;
  }
  const int col = n0 + threadIdx.x;
  const int r0 = a.offsets[e], m = a.offsets[e + 1] - r0;
  const float* wd = a.wd + static_cast<size_t>(e) * a.ff * a.d + col;
  for (int r = 0; r < m; ++r) {
    const float* hr = a.h + static_cast<size_t>(r0 + r) * a.ff;
    float acc = 0.0f;
    for (int k = 0; k < a.ff; ++k)
      acc = fmaf(hr[k], wd[static_cast<size_t>(k) * a.d], acc);
    a.y[static_cast<size_t>(a.perm[r0 + r]) * a.d + col] = acc;
  }
}

// a launch that may start while the previous one runs (its blocks wait in
// wait_for_previous)
template <typename A>
int launch_after(void (*kernel)(A), dim3 grid, size_t smem, const A& args,
                 cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args);
}

template <typename T>
Args<T> make_args(const void* x, const void* perm, const void* offsets,
                  const void* wg, const void* wu, const void* wd, void* h,
                  void* y, int N, int top_k, int d, int ff, int n) {
  return Args<T>{static_cast<const T*>(x), static_cast<const int*>(perm),
                 static_cast<const int*>(offsets), static_cast<const T*>(wg),
                 static_cast<const T*>(wu), static_cast<const T*>(wd),
                 static_cast<T*>(h), static_cast<T*>(y), N, top_k, d, ff, n};
}

int set_smem(const void* kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// flat_e (N,) int64 expert per entry; perm (N,) and offsets (n + 2,) int32
// out. n <= 256 (checked by ops.py). Launches one block on `stream` and
// returns a CUDA error code (0 = launched).
extern "C" int moe_dispatch(const void* flat_e, int N, int first, int n,
                            void* perm, void* offsets, void* stream) {
  moe_dispatch_sort<<<1, kDispatchThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(flat_e), N, first, n,
      static_cast<int*>(perm), static_cast<int*>(offsets));
  return (int)cudaGetLastError();
}

// x (N / top_k, d); perm, offsets from moe_dispatch; wg, wu (n, d, ff); wd
// (n, ff, d); scratch h (N, ff); y (N, d). All contiguous and 16-byte
// aligned, d % 128 == 0, ff % 64 == 0 (checked by ops.py). Launches gate/up
// then down on `stream`, each a programmatic dependent launch, and returns a
// CUDA error code (0 = launched).
extern "C" int moe_experts_bf16(const void* x, const void* perm,
                                const void* offsets, const void* wg,
                                const void* wu, const void* wd, void* h,
                                void* y, int N, int top_k, int d, int ff,
                                int n, void* stream) {
  // the shared-memory opt-in, once per device (the first call is an eager
  // one: a graph capture runs its body eagerly first)
  static int ready[kMaxDevices] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = set_smem((const void*)moe_experts_gate_up, kGateUpSmem);
    if (err == 0) err = set_smem((const void*)moe_experts_down, kDownSmem);
    if (err != 0) return err;
    ready[dev] = 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args<bf16> a =
      make_args<bf16>(x, perm, offsets, wg, wu, wd, h, y, N, top_k, d, ff, n);
  err = launch_after(moe_experts_gate_up, dim3(ff / kTF, n), kGateUpSmem, a,
                     s);
  if (err != 0) return err;
  return launch_after(moe_experts_down, dim3(d / kTN, n + 1), kDownSmem, a, s);
}

extern "C" int moe_experts_f32(const void* x, const void* perm,
                               const void* offsets, const void* wg,
                               const void* wu, const void* wd, void* h,
                               void* y, int N, int top_k, int d, int ff,
                               int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args<float> a =
      make_args<float>(x, perm, offsets, wg, wu, wd, h, y, N, top_k, d, ff, n);
  int err = launch_after(moe_experts_gate_up_f32, dim3(ff / kTF, n), 0, a, s);
  if (err != 0) return err;
  return launch_after(moe_experts_down_f32, dim3(d / kTN, n + 1), 0, a, s);
}

extern "C" const char* moe_experts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
