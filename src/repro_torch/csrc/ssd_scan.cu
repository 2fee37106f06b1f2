// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/ssd_scan/kernel.py::_ssd_kernel of the JAX
// reference (launcher ssd_scan_kernel, wrapper ops.ssd_scan). Python side:
// repro_torch/kernels/ssd_scan/ (kernel.py binds these entry points, ops.py
// checks the arguments, ref.py is the plain PyTorch version this kernel is
// tested against).
//
// Computes, per batch row b and head h from state 0, the recurrence
//   S_t = exp(dt_t A_h) S_{t-1} + (dt_t x_t) B_t^T,   y_t = S_t C_t
// with x (B, L, H, P), dt (B, L, H) f32, A (H,) f32, and B, C (B, L, G, N)
// read at group g = h / (H / G). y (B, L, H, P) is written in x's dtype
// (the reference's wrapper casts its f32 y there too); the final state
// (B, H, P, N) is f32. x, dt, B and C are read in that layout through their
// strides (last dim contiguous): no head-major copy of x or dt and no
// group-to-head repeat of B and C, where the reference wrapper made both.
// xdt = x * dt and a = dt * A are formed here, in f32, as the Pallas body
// receives them.
//
// The arithmetic is the Pallas body's, chunk by chunk: with acs the inclusive
// cumsum of a inside the chunk,
//   intra-chunk    y_i += sum_{j <= i} (C_i . B_j) exp(acs_i - acs_j) xdt_j
//   carried state  y_i += exp(acs_i) S C_i
//   state update   S' = exp(acs_last) S
//                       + sum_j exp(acs_last - acs_j) xdt_j B_j^T
// all in f32. exp(acs_i - acs_j) is evaluated only where i >= j: above the
// diagonal it could overflow and turn 0 * inf into NaN. The chunk here is
// kQ = 64 tokens whatever the model's chunk_size (256 at mamba2-130m): the
// recurrence is the same function at any chunk, only the rounding moves, and
// a 64-token chunk keeps B, C and the score tile in shared memory (a 256-token
// chunk would need 128 KB each for B and C and 256 KB for the scores in f32).
// A ragged last chunk is masked as the reference's XLA route pads it, with
// dt = 0 (no decay, no update): the final state is the state after the last
// real token, and the reference wrapper's `s % chunk == 0` assert is gone.
//
// What bounds it on the card: arithmetic, at the main path's shape (1, 2048,
// 24, 64, g 1, N 128): ~4 GFLOP of products over ~15 MB of inputs and outputs.
// What the design does about it, simply: one thread block per (p-slice of
// kPS = 16 head-dim columns, head, batch row) walks the chunks in order with
// its 16 x N slice of the state in shared memory, so the sequential chunk
// axis of the TPU grid becomes a loop inside the block and nothing carries
// between blocks. The state's rows are independent in p (row p of S and
// column p of y read only column p of xdt), so splitting P four ways gives
// 96 blocks at batch 1 instead of 24, at the price of recomputing the
// C . B^T score tile per slice. Each chunk runs five phases between barriers:
// load B^T, C^T (padded rows against bank conflicts), xdt and a; cumsum; the
// masked, decayed 64 x 64 score tile (4 x 4 register blocks per thread); y
// rows (intra-chunk plus carried state) and xdt scaled to the chunk end; the
// state update in place.
//
// What it leaves on the table, for later work (ROADMAP Queue 2 row 3): the
// products run on the f32 CUDA cores (no wgmma / mma.sync; bf16 is widened
// at load), tiles are loaded with plain loads between barriers (no cp.async /
// TMA double buffering), and the chunks of one (batch, head) run in sequence.
// A two-pass design (per-chunk states in parallel, a short carry pass, then
// the carried term) would put L / chunk times more blocks to work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;          // tokens per chunk
constexpr int kPS = 16;         // head-dim columns per block
constexpr int kQP = kQ + 1;     // row stride of B^T, C^T and the score tile
constexpr int kSP = kPS + 1;    // row stride of the transposed state slice
constexpr int kMaxN = 256;      // d_state limit (shared memory)

static_assert(kThreads == 16 * 16 && kQ == 4 * 16 && kPS == 16,
              "the thread layouts below assume these sizes");

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

__host__ __device__ constexpr int smem_floats(int N) {
  return 2 * N * kQP      // B^T, C^T
         + kQ * kQP       // score tile
         + 2 * kQ * kPS   // xdt, xdt scaled to the chunk end
         + N * kSP        // state slice, transposed
         + 3 * kQ;        // acs, exp(acs), exp(acs_last - acs)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int B, int L, int H, int P,
           int G, int N, const int64_t* strides, void* stream) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || G < 1 || H % G || N < 1 ||
      N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_floats(N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const dim3 grid((P + kPS - 1) / kPS, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, H / G, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), B and C (B, L, G, N) of one dtype, dt (B, L, H) f32, each
// with element strides strides = {x_b, x_s, x_h, dt_b, dt_s, dt_h, B_b, B_s,
// B_g, C_b, C_s, C_g} and a contiguous last dim; A (H,) f32 contiguous; y
// (B, L, H, P) in x's dtype and state (B, H, P, N) f32, both contiguous
// (checked by ops.py). N <= 256 and H % G == 0, else cudaErrorInvalidValue.
// Launches on `stream` and returns a CUDA error code (0 = launched).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* state, int B, int L, int H, int P, int G,
                            int N, const int64_t* strides, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, y, state, B, L, H, P, G, N, strides,
                       stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* state, int B, int L, int H, int P, int G,
                             int N, const int64_t* strides, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, L, H, P, G, N,
                               strides, stream);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
