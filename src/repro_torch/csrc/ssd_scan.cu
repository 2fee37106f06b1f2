// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/ssd_scan/kernel.py::_ssd_kernel of the JAX
// reference (launcher ssd_scan_kernel, wrapper ops.ssd_scan). Python side:
// repro_torch/kernels/ssd_scan/ (kernel.py binds these entry points, ops.py
// checks the arguments and picks the route, ref.py holds the plain PyTorch
// version this kernel is tested against and a plain model of the three
// passes below).
//
// Computes, per batch row b and head h from state 0, the recurrence
//   S_t = exp(dt_t A_h) S_{t-1} + (dt_t x_t) B_t^T,   y_t = S_t C_t
// with x (B, L, H, P), dt (B, L, H) f32, A (H,) f32, and B, C (B, L, G, N)
// read at group g = h / (H / G). y (B, L, H, P) is written in x's dtype
// (the reference's wrapper casts its f32 y there too); the final state
// (B, H, P, N) is f32. x, dt, B and C are read in that layout through their
// strides (last dim contiguous): no head-major copy of x or dt and no
// group-to-head repeat of B and C, where the reference wrapper made both;
// in the served prefill x, B and C are views of one (B, L, conv_dim) tensor.
//
// The arithmetic is the Pallas body's, chunk by chunk: with acs the inclusive
// cumsum of a = dt A inside the chunk,
//   intra-chunk    y_i += sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) dt_j x_j
//   carried state  y_i += exp(acs_i) S C_i
//   state update   S' = exp(acs_last) S
//                       + sum_j exp(acs_last - acs_j) dt_j x_j B_j^T
// exp(acs_i - acs_j) is evaluated only where i >= j: above the diagonal it
// could overflow and turn 0 * inf into NaN. A ragged last chunk is masked as
// the reference's XLA route pads it, with dt = 0 (no decay, no update): the
// final state is the state after the last real token, and the reference
// wrapper's `s % chunk == 0` assert is gone.
//
// Two routes, chosen by ops.py:
//
// * bf16 with P and N multiples of 16 (P <= 128, N <= 256) and 16-byte
//   aligned rows -> the tensor-core route, three launches (the SSD paper's
//   own decomposition, arXiv:2405.21060 section 6), chunk Q in {64, 128, 256}
//   tokens (ops.py's MMA_CHUNK, from the sweep in PERF.md):
//   1. ssd_scan_state, one block of 4 warps per (chunk, head, batch row):
//      B and x rows copied in by cp.async while acs is computed by
//      warp-shuffle inclusive scans of 32 tokens and the segments' totals
//      added in order; x_j dt_j exp(acs_last - acs_j) rounded to bf16 in
//      place in shared memory; the chunk's end state from 0,
//      S_c = (that)^T . B, a (P x Q) . (Q x N) product on mma.sync m16n8k16
//      (bf16 in, f32 accumulate) with both operands from ldmatrix.trans.
//      S_c (f32) and acs go to scratch that the wrapper allocates.
//   2. ssd_scan_carry, one thread per (p, n, head, batch row) walks the
//      chunks in order: S_in[c + 1] = exp(acs_last[c]) S_in[c] + S_c[c]; it
//      writes S_in[c] in bf16 for pass 3 and the last value, the final
//      state, in f32.
//   3. ssd_scan_output<P>, one block of 4 warps per (64-row tile, chunk,
//      head, batch row), causal attention without the softmax: queries C,
//      keys B, values x. Each warp takes 16 rows; the carried term
//      (C . S_in^T) scaled by exp(acs_i) starts the accumulator, then every
//      key tile up to the diagonal adds P X with
//      P_ij = (C_i . B_j) exp(acs_i - acs_j) dt_j, formed in f32 registers
//      on the mma accumulator and packed to bf16 as flash attention packs
//      its probabilities; key tiles above the diagonal are skipped, and
//      only the diagonal tile masks. B and x tiles are double-buffered by
//      16-byte cp.async, zero-filled past L.
//   Passes 2 and 3 are programmatic dependent launches: each is scheduled
//   while the pass before it runs and waits for it in griddepcontrol.wait;
//   pass 3 fetches its C rows, first B and x tiles and dt before it waits.
//   Every sum runs in a fixed order with no atomics, so two calls on the
//   same inputs give the same bits.
// * f32, or a shape the tiles cannot take -> ssd_scan_simt<T>, the first
//   design, on the f32 CUDA cores: one block per (16 head-dim
//   columns, head, batch row) walks 64-token chunks in order with its state
//   slice in shared memory, five barrier-separated phases a chunk. TF32
//   would break the 2e-4 f32 tolerance, as flash attention found.
//
// What bounds it on the card: at the main path's shape (1, 2048, 24, 64,
// g 1, N 128) in bf16 the function needs ~0.02 GFLOP of products per
// (chunk, head) at the model's 256-token chunk over ~15 MB of inputs and
// outputs, so memory, ~0.0044 ms at 3.35 TB/s. The tensor-core route
// moves more: the chunk states, 0.79 MB per chunk at (24, 64, 128) in f32,
// are written, read, written in bf16 and read again; that scratch, the
// L / 64 x H blocks of pass 3 and three launches are what the chunk
// length trades against the intra-chunk products (PERF.md's sweep).
// What it leaves for later (ROADMAP Queue 2 row 3): pass 3 on wgmma with
// TMA tile loads, and the carry folded into pass 3.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

struct Strides {   // element strides; the last dim of each is contiguous
  int64_t x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s, B_g, C_b, C_s, C_g;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

Strides make_strides(const int64_t* s) {
  return {s[0], s[1], s[2], s[3], s[4], s[5],
          s[6], s[7], s[8], s[9], s[10], s[11]};
}

// ------------------------------------ f32 / any shape: CUDA cores (simt)

namespace simt {

constexpr int kThreads = 256;
constexpr int kQ = 64;          // tokens per chunk
constexpr int kPS = 16;         // head-dim columns per block
constexpr int kQP = kQ + 1;     // row stride of B^T, C^T and the score tile
constexpr int kSP = kPS + 1;    // row stride of the transposed state slice
constexpr int kMaxN = 256;      // d_state limit (shared memory)

static_assert(kThreads == 16 * 16 && kQ == 4 * 16 && kPS == 16,
              "the thread layouts below assume these sizes");

__host__ __device__ constexpr int smem_floats(int N) {
  return 2 * N * kQP      // B^T, C^T
         + kQ * kQP       // score tile
         + 2 * kQ * kPS   // xdt, xdt scaled to the chunk end
         + N * kSP        // state slice, transposed
         + 3 * kQ;        // acs, exp(acs), exp(acs_last - acs)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_simt(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, T* __restrict__ y,
                    float* __restrict__ state, int L, int H, int P, int N,
                    int rep, Strides st) {
  extern __shared__ float smem[];
  float* Bt = smem;                  // [N][kQP]  B of the chunk, transposed
  float* Ct = Bt + N * kQP;          // [N][kQP]  C of the chunk, transposed
  float* G = Ct + N * kQP;           // [kQ][kQP] masked, decayed C . B^T
  float* xdt = G + kQ * kQP;         // [kQ][kPS] x * dt
  float* xdtw = xdt + kQ * kPS;      // [kQ][kPS] xdt * exp(acs_last - acs)
  float* St = xdtw + kQ * kPS;       // [N][kSP]  state slice, S[p][n] at
                                     //           St[n * kSP + p]
  float* acs = St + N * kSP;         // [kQ] inclusive cumsum of dt * A
  float* eacs = acs + kQ;            // [kQ] exp(acs)
  float* w = eacs + kQ;              // [kQ] exp(acs_last - acs)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float a_h = A[h];
  const T* xb = x + b * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.B_b + (h / rep) * st.B_g;
  const T* Cb = Cm + b * st.C_b + (h / rep) * st.C_g;
  T* yb = y + ((int64_t)b * L * H + h) * P + p0;
  const int64_t y_s = (int64_t)H * P;

  for (int e = tid; e < N * kSP; e += kThreads) St[e] = 0.f;

  for (int s0 = 0; s0 < L; s0 += kQ) {
    const int q = min(kQ, L - s0);   // real tokens in this chunk

    // 1. load the chunk; rows past L read as dt = 0 and zero B, C, x
    for (int e = tid; e < kQ * N; e += kThreads) {
      const int j = e / N, k = e - j * N;
      float bv = 0.f, cv = 0.f;
      if (j < q) {
        bv = to_float(Bb[(s0 + j) * st.B_s + k]);
        cv = to_float(Cb[(s0 + j) * st.C_s + k]);
      }
      Bt[k * kQP + j] = bv;
      Ct[k * kQP + j] = cv;
    }
    for (int e = tid; e < kQ * kPS; e += kThreads) {
      const int j = e / kPS, pp = e - j * kPS;
      float v = 0.f;
      if (j < q && p0 + pp < P)
        v = to_float(xb[(s0 + j) * st.x_s + pp]) * dtb[(s0 + j) * st.dt_s];
      xdt[e] = v;
    }
    if (tid < kQ) acs[tid] = tid < q ? dtb[(s0 + tid) * st.dt_s] * a_h : 0.f;
    __syncthreads();

    // 2. inclusive cumsum of the log decays (64 adds, in order)
    if (tid == 0) {
      float c = 0.f;
      for (int j = 0; j < kQ; ++j) {
        c += acs[j];
        acs[j] = c;
      }
    }
    __syncthreads();

    // 3. decays, and the score tile G[i][j] = (C_i . B_j) exp(acs_i - acs_j)
    //    for i >= j, else 0; thread (ti, tj) owns rows ti + 16 r, columns
    //    tj + 16 c
    if (tid < kQ) {
      eacs[tid] = expf(acs[tid]);
      w[tid] = expf(acs[kQ - 1] - acs[tid]);
    }
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float c[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) c[r] = Ct[k * kQP + ti + 16 * r];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = Bt[k * kQP + tj + 16 * r];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[r][cc] = fmaf(c[r], bv[cc], acc[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = ti + 16 * r, j = tj + 16 * cc;
          G[i * kQP + j] =
              i >= j ? acc[r][cc] * expf(acs[i] - acs[j]) : 0.f;
        }
    }
    __syncthreads();

    // 4. y for rows i0 .. i0+3 and column pp: the intra-chunk sum (G is 0
    //    above the diagonal, so keys stop at the last row) plus the carried
    //    state; then xdt scaled by each row's decay to the chunk's end
    {
      const int pp = tid % 16, i0 = (tid / 16) * 4;
      float acc[4] = {}, car[4] = {};
      for (int j = 0; j < i0 + 4; ++j) {
        const float xv = xdt[j * kPS + pp];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] = fmaf(G[(i0 + r) * kQP + j], xv, acc[r]);
      }
      for (int k = 0; k < N; ++k) {
        const float sv = St[k * kSP + pp];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          car[r] = fmaf(Ct[k * kQP + i0 + r], sv, car[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i < q && p0 + pp < P)
          store(yb + (s0 + i) * y_s + pp, acc[r] + eacs[i] * car[r]);
        xdtw[i * kPS + pp] = xdt[i * kPS + pp] * w[i];
      }
    }
    __syncthreads();

    // 5. state update in place: S[p][n] = exp(acs_last) S[p][n]
    //    + sum_j xdtw[j][p] B[j][n]; a unit is one n and four p's
    {
      const float d_last = eacs[kQ - 1];
      for (int e = tid; e < N * (kPS / 4); e += kThreads) {
        const int k = e % N, p4 = (e / N) * 4;
        float acc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = d_last * St[k * kSP + p4 + r];
        for (int j = 0; j < q; ++j) {
          const float bv = Bt[k * kQP + j];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[r] = fmaf(xdtw[j * kPS + p4 + r], bv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) St[k * kSP + p4 + r] = acc[r];
      }
    }
    __syncthreads();
  }

  // the final state, (B, H, P, N) f32
  float* sb = state + ((int64_t)b * H + h) * P * N;
  for (int e = tid; e < kPS * N; e += kThreads) {
    const int pp = e / N, k = e - pp * N;
    if (p0 + pp < P) sb[(int64_t)(p0 + pp) * N + k] = St[k * kSP + pp];
  }
}

template <typename T>
int launch_simt(const void* x, const void* dt, const void* A,
                const void* Bm, const void* Cm, void* y, void* state, int B,
                int L, int H, int P, int G, int N, const int64_t* strides,
                void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || G < 1 || H % G || N < 1 ||
      N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_simt<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Strides st = make_strides(strides);
  const dim3 grid((P + kPS - 1) / kPS, H, B);
  ssd_scan_simt<T><<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, H / G, st);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------ bf16: tensor cores (three passes)

namespace tc {

using bf16 = __nv_bfloat16;
using namespace sm90;  // cp.async, ldmatrix, mma.sync (mma_sm90.cuh)

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 64;      // rows of an output tile, keys of a key tile
constexpr int kMaxQ = 256;
constexpr int kMaxN = 256;
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// programmatic dependent launch: let the next pass be scheduled now; wait
// until the previous pass has finished and its writes are visible
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous_pass() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  bf16* y;
  float* state;
  float* sc;   // (B, H, nc, P, N) f32: each chunk's end state from 0
  bf16* sin;   // (B, H, nc, P, N) bf16: the state entering each chunk
  float* acs;  // (B, H, nc, Q) f32: cumsum of dt A inside each chunk
  int L, H, P, N, rep, Q, nc;
  Strides st;
};

// `rows` rows of `cols` bf16 (row r at src + r * row_stride) into shared
// memory rows `ds` elements apart, 16 bytes per cp.async by the block's
// threads; rows at or past `valid` are zero-filled and not read
__device__ __forceinline__ void copy_rows(const bf16* src, int64_t row_stride,
                                          int rows, int valid, int cols,
                                          bf16* dst, int ds) {
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int col = (idx - r * chunks) * 8;
    const bool ok = r < valid;
    cp_async16(smem_addr(dst + r * ds + col),
               ok ? src + (int64_t)r * row_stride + col : src, ok);
  }
}

// Pass 1: one block per (chunk, head, batch row).
__global__ void __launch_bounds__(kThreads) ssd_scan_state(Args g) {
  extern __shared__ uint4 smem_u4[];
  launch_dependents();
  const int Q = g.Q, P = g.P, N = g.N;
  const int xs_s = P + 8, bs_s = N + 8;  // +16 bytes a row: no bank conflicts
  bf16* xs = reinterpret_cast<bf16*>(smem_u4);  // [Q][P+8] scaled x
  bf16* bt = xs + Q * xs_s;                     // [Q][N+8] B
  float* acs_s = reinterpret_cast<float*>(bt + Q * bs_s);  // [Q]
  float* dt_s = acs_s + Q;                                 // [Q]
  float* tot = dt_s + Q;                                   // [Q / 32]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Strides& st = g.st;
  const int s0 = c * Q;
  const int valid = g.L - s0;  // real tokens from the chunk's start
  const int64_t bh = (int64_t)b * g.H + h;

  // B and x rows in flight while acs is computed (x is scaled in place)
  copy_rows(g.Bm + b * st.B_b + (h / g.rep) * st.B_g + (int64_t)s0 * st.B_s,
            st.B_s, Q, valid, N, bt, bs_s);
  copy_rows(g.x + b * st.x_b + h * st.x_h + (int64_t)s0 * st.x_s, st.x_s, Q,
            valid, P, xs, xs_s);
  cp_async_commit();

  // acs: each warp scans segments of 32 tokens with shuffles (dt = 0 past
  // L), then every token adds the totals of the segments before its own,
  // in segment order
  const float* dtb = g.dt + b * st.dt_b + h * st.dt_h;
  const float a_h = g.A[h];
  for (int seg = warp; seg < Q / 32; seg += kThreads / 32) {
    const int j = seg * 32 + lane;
    const float d = j < valid ? dtb[(int64_t)(s0 + j) * st.dt_s] : 0.f;
    float v = d * a_h;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    dt_s[j] = d;
    acs_s[j] = v;
    if (lane == 31) tot[seg] = v;
  }
  __syncthreads();
  float* acs_g = g.acs + (bh * g.nc + c) * Q;
  for (int j = threadIdx.x; j < Q; j += kThreads) {
    float pre = 0.f;
    for (int seg = 0; seg < j / 32; ++seg) pre += tot[seg];
    acs_s[j] += pre;
    acs_g[j] = acs_s[j];
  }
  cp_async_wait<0>();
  __syncthreads();

  // x_j dt_j exp(acs_last - acs_j) in f32, rounded to bf16, in place
  // (rows past L were zero-filled)
  const float last = acs_s[Q - 1];
  const int chunks = P / 8, n_x = min(Q, valid) * chunks;
  for (int idx = threadIdx.x; idx < n_x; idx += kThreads) {
    const int r = idx / chunks;
    uint4* row = reinterpret_cast<uint4*>(xs + r * xs_s) + idx % chunks;
    const float w = dt_s[r] * expf(last - acs_s[r]);
    uint4 v = *row;
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(u + e));
      u[e] = pack_bf16(f.x * w, f.y * w);
    }
    *row = v;
  }
  __syncthreads();

  // S_c (P x N) = xs^T (P x Q) . B (Q x N): a warp's task is 16 rows of P
  // by 64 columns of N; xs is stored [k][m], so A comes by ldmatrix.trans
  float* scb = g.sc + (bh * g.nc + c) * (int64_t)P * N;
  const int n_mt = P / 16, n_tasks = n_mt * ((N + 63) / 64);
  for (int task = warp; task < n_tasks; task += kThreads / 32) {
    const int m0 = (task % n_mt) * 16, n0 = (task / n_mt) * 64;
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int kk = 0; kk < Q; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4_trans(
          smem_addr(xs + kk * xs_s + m0 + a_lane_km(lane, xs_s)), a);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        if (n0 + nn * 16 < N) {
          uint32_t bb[4];
          ldmatrix_x4_trans(smem_addr(bt + kk * bs_s + n0 + nn * 16 +
                                      b_lane_kn(lane, bs_s)),
                            bb);
          mma_16816(acc[2 * nn], a, bb[0], bb[1]);
          mma_16816(acc[2 * nn + 1], a, bb[2], bb[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = n0 + t * 8 + (lane % 4) * 2;
      if (col < N) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m0 + lane / 4 + 8 * i;
          *reinterpret_cast<float2*>(scb + (int64_t)row * N + col) =
              make_float2(acc[t][2 * i], acc[t][2 * i + 1]);
        }
      }
    }
  }
}

// Pass 2: one thread per (p, n, head, batch row) walks the chunks in order.
__global__ void __launch_bounds__(kCarryThreads) ssd_scan_carry(Args g) {
  launch_dependents();
  wait_for_previous_pass();  // pass 1's end states and cumsums
  const int PN = g.P * g.N;
  const int e = blockIdx.x * kCarryThreads + threadIdx.x;
  if (e >= PN) return;
  const int64_t bh = (int64_t)blockIdx.z * g.H + blockIdx.y;
  const float* sc = g.sc + bh * g.nc * PN + e;
  bf16* sin = g.sin + bh * g.nc * PN + e;
  const float* last = g.acs + bh * g.nc * g.Q + g.Q - 1;
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < g.nc; ++c) {
    const float v = sc[(int64_t)c * PN];
    sin[(int64_t)c * PN] = __float2bfloat16(s);
    s = __fadd_rn(__fmul_rn(expf(last[(int64_t)c * g.Q]), s), v);
  }
  g.state[bh * PN + e] = s;
}

// Pass 3: one block per (64-row tile, chunk, head, batch row); the tiles of
// a chunk with the most key tiles are launched first.
template <int P>
__global__ void __launch_bounds__(kThreads) ssd_scan_output(Args g) {
  constexpr int kDT = P / 8;      // n8 tiles of a warp's 16 x P output
  constexpr int xs_s = P + 8;
  extern __shared__ uint4 smem_u4[];
  const int Q = g.Q, N = g.N, cs_s = N + 8;
  const int tiles = Q / kTile;
  const int c = blockIdx.x / tiles;
  const int rt = tiles - 1 - blockIdx.x % tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Strides& st = g.st;
  const int s0 = c * Q, i0 = rt * kTile;  // chunk start; tile's first row
  const int valid = g.L - s0;             // real tokens from s0
  const int64_t bh = (int64_t)b * g.H + h;

  bf16* cs = reinterpret_cast<bf16*>(smem_u4);  // [64][N+8] C rows
  bf16* si = cs + kTile * cs_s;                 // [P][N+8] S_in
  bf16* bt = si + P * cs_s;                     // 2 stages of [64][N+8] B
  bf16* xt = bt + 2 * kTile * cs_s;             // 2 stages of [64][P+8] x
  float* acs_s = reinterpret_cast<float*>(xt + 2 * kTile * xs_s);  // [Q]
  float* dt_s = acs_s + Q;                                         // [Q]

  const int grp = h / g.rep;
  const bf16* Bb = g.Bm + b * st.B_b + grp * st.B_g + (int64_t)s0 * st.B_s;
  const bf16* Cb = g.Cm + b * st.C_b + grp * st.C_g + (int64_t)s0 * st.C_s;
  const bf16* xb = g.x + b * st.x_b + h * st.x_h + (int64_t)s0 * st.x_s;

  // what does not depend on the earlier passes is fetched before waiting
  // for them: copy group {C rows, first key tile}, dt; then {S_in} and
  // the cumsums; then one group per further key tile, in order
  copy_rows(Cb + (int64_t)i0 * st.C_s, st.C_s, kTile, valid - i0, N, cs,
            cs_s);
  copy_rows(Bb, st.B_s, kTile, valid, N, bt, cs_s);
  copy_rows(xb, st.x_s, kTile, valid, P, xt, xs_s);
  cp_async_commit();
  const float* dtb = g.dt + b * st.dt_b + h * st.dt_h;
  for (int j = threadIdx.x; j < i0 + kTile; j += kThreads)
    dt_s[j] = j < valid ? dtb[(int64_t)(s0 + j) * st.dt_s] : 0.f;
  wait_for_previous_pass();  // pass 2's S_in (and, before it, pass 1's acs)
  if (c > 0)
    copy_rows(g.sin + (bh * g.nc + c) * (int64_t)P * N, N, P, P, N, si, cs_s);
  cp_async_commit();
  const float* acs_g = g.acs + (bh * g.nc + c) * Q;
  for (int j = threadIdx.x; j < i0 + kTile; j += kThreads)
    acs_s[j] = acs_g[j];

  // this thread's rows in the chunk: r0 and r0 + 8 (mma C layout)
  const int r0 = i0 + warp * 16 + lane / 4;
  const uint32_t c_addr =
      smem_addr(cs + warp * 16 * cs_s + a_lane(lane, cs_s));
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  cp_async_wait<0>();  // C rows, the first key tile and S_in landed
  __syncthreads();
  const float a0 = acs_s[r0], a1 = acs_s[r0 + 8];
  if (c > 0) {
    // carried term: (C . S_in^T) exp(acs_i); S_in is stored [p][n], the
    // B operand's [n][k] layout
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(c_addr + kk * 2, a);
#pragma unroll
      for (int nn = 0; nn < P / 16; ++nn) {
        uint32_t bb[4];
        ldmatrix_x4(
            smem_addr(si + nn * 16 * cs_s + kk + b_lane_nk(lane, cs_s)), bb);
        mma_16816(o[2 * nn], a, bb[0], bb[1]);
        mma_16816(o[2 * nn + 1], a, bb[2], bb[3]);
      }
    }
    const float e0 = expf(a0), e1 = expf(a1);
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= e0;
      o[d][1] *= e0;
      o[d][2] *= e1;
      o[d][3] *= e1;
    }
  }

  for (int kt = 0; kt <= rt; ++kt) {
    const int stg = kt & 1;
    cp_async_wait<0>();  // this key tile landed
    __syncthreads();     // ... for every warp; the other stage is free
    if (kt < rt) {
      const int k1 = (kt + 1) * kTile;
      copy_rows(Bb + (int64_t)k1 * st.B_s, st.B_s, kTile, valid - k1, N,
                bt + (stg ^ 1) * kTile * cs_s, cs_s);
      copy_rows(xb + (int64_t)k1 * st.x_s, st.x_s, kTile, valid - k1, P,
                xt + (stg ^ 1) * kTile * xs_s, xs_s);
    }
    cp_async_commit();
    const bf16* bs = bt + stg * kTile * cs_s;
    const bf16* xs = xt + stg * kTile * xs_s;

    // scores C . B^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < N; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(c_addr + kk * 2, a);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t bb[4];
        ldmatrix_x4(
            smem_addr(bs + nn * 16 * cs_s + kk + b_lane_nk(lane, cs_s)), bb);
        mma_16816(s[2 * nn], a, bb[0], bb[1]);
        mma_16816(s[2 * nn + 1], a, bb[2], bb[3]);
      }
    }

    // P_ij = s_ij exp(acs_i - acs_j) dt_j for j <= i (only the diagonal
    // tile masks), packed to bf16 as the A operand of P X: the C layout of
    // score tiles 2kk and 2kk + 1 is the A layout of k-step kk
    const int k0 = kt * kTile;
    const bool diag = kt == rt;
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + (lane % 4) * 2 + e % 2;
        const int row = r0 + (e / 2) * 8;
        const float ai = e < 2 ? a0 : a1;
        p[e] = (!diag || key <= row)
                   ? s[j][e] * (exp2f((ai - acs_s[key]) * kLog2e) * dt_s[key])
                   : 0.f;
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // y += P X, X^T fragments by ldmatrix.trans from the [key][p] tile
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int dd = 0; dd < P / 16; ++dd) {
        uint32_t bb[4];
        ldmatrix_x4_trans(smem_addr(xs + kk * 16 * xs_s + dd * 16 +
                                    b_lane_kn(lane, xs_s)),
                          bb);
        mma_16816(o[2 * dd], pa[kk], bb[0], bb[1]);
        mma_16816(o[2 * dd + 1], pa[kk], bb[2], bb[3]);
      }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends

  // y (B, L, H, P) contiguous, rows past L not written
  const int64_t y_s = (int64_t)g.H * P;
  bf16* yb = g.y + ((int64_t)b * g.L * g.H + h) * P;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row < valid) {
#pragma unroll
      for (int d = 0; d < kDT; ++d)
        *reinterpret_cast<__nv_bfloat162*>(
            yb + (int64_t)(s0 + row) * y_s + d * 8 + (lane % 4) * 2) =
            __floats2bfloat162_rn(o[d][2 * i], o[d][2 * i + 1]);
    }
  }
}

// a launch that may start while the previous pass runs (its blocks wait
// in wait_for_previous_pass)
int launch_after(void (*kernel)(Args), dim3 grid, int threads, size_t smem,
                 const Args& g, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, g);
}

template <int P>
int launch_output(const Args& g, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(3 * kTile + P) * (g.N + 8) * sizeof(bf16) +
                      (size_t)2 * kTile * (P + 8) * sizeof(bf16) +
                      (size_t)2 * g.Q * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_output<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return launch_after(ssd_scan_output<P>,
                      dim3(g.nc * (g.Q / kTile), g.H, B), kThreads, smem, g,
                      stream);
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, void* sc, void* sin,
           void* acs, int B, int L, int H, int P, int G, int N, int Q,
           const int64_t* strides, void* stream) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || N < 16 || N > kMaxN ||
      N % 16 || Q < kTile || Q > kMaxQ || Q % kTile)
    return (int)cudaErrorInvalidValue;
  if (P != 16 && P != 32 && P != 64 && P != 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (L + Q - 1) / Q;
  const Args g = {static_cast<const bf16*>(x),  static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
                  static_cast<float*>(state),   static_cast<float*>(sc),
                  static_cast<bf16*>(sin),      static_cast<float*>(acs),
                  L, H, P, N, H / G, Q, nc, make_strides(strides)};

  const size_t smem1 = (size_t)Q * (P + 8 + N + 8) * sizeof(bf16) +
                       (size_t)(2 * Q + Q / 32) * sizeof(float);
  if (smem1 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem1);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_scan_state<<<dim3(nc, H, B), kThreads, smem1, s>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = (cudaError_t)launch_after(
      ssd_scan_carry,
      dim3((P * N + kCarryThreads - 1) / kCarryThreads, H, B), kCarryThreads,
      0, g, s);
  if (e != cudaSuccess) return (int)e;

  switch (P) {
    case 16: return launch_output<16>(g, B, s);
    case 32: return launch_output<32>(g, B, s);
    case 64: return launch_output<64>(g, B, s);
    default: return launch_output<128>(g, B, s);
  }
}

}  // namespace tc

}  // namespace

// x (B, L, H, P), B and C (B, L, G, N) of one dtype, dt (B, L, H) f32, each
// with element strides strides = {x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s,
// B_g, C_b, C_s, C_g} and a contiguous last dim; A (H,) f32 contiguous; y
// (B, L, H, P) in x's dtype and state (B, H, P, N) f32, both contiguous
// (checked by ops.py). Each entry point launches on `stream` and returns a
// CUDA error code (0 = launched).
//
// The CUDA-core route, one launch: N <= 256 and H % G == 0, else
// cudaErrorInvalidValue.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state, int B, int L, int H, int P, int G,
                            int N, const int64_t* strides, void* stream) {
  return simt::launch_simt<float>(x, dt, A, Bm, Cm, y, state, B, L, H, P, G,
                                  N, strides, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* state, int B, int L, int H, int P, int G,
                             int N, const int64_t* strides, void* stream) {
  return simt::launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, L,
                                          H, P, G, N, strides, stream);
}

// The tensor-core route, three launches, bf16 only: P in {16, 32, 64, 128},
// N a multiple of 16 up to 256, chunk Q in {64, 128, 256}; x, B and C with
// 16-byte-aligned bases and strides that are multiples of 8 elements
// (checked by ops.py). Scratch, with nc = ceil(L / Q): sc (B, H, nc, P, N)
// f32, sin (B, H, nc, P, N) bf16, acs (B, H, nc, Q) f32.
extern "C" int ssd_scan_mma_bf16(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, void* y,
                                 void* state, void* sc, void* sin, void* acs,
                                 int B, int L, int H, int P, int G, int N,
                                 int Q, const int64_t* strides, void* stream) {
  return tc::launch(x, dt, A, Bm, Cm, y, state, sc, sin, acs, B, L, H, P, G,
                    N, Q, strides, stream);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
