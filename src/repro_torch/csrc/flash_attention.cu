// Flash attention (forward, causal, optionally sliding-window, GQA) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attention/kernel.py::_attn_kernel of
// the JAX reference (launcher flash_attention_kernel, wrapper
// ops.flash_attention). Python side: repro_torch/kernels/flash_attention/
// (kernel.py binds these entry points, ops.py checks the arguments, ref.py is
// the plain PyTorch version this kernel is tested against).
//
// Computes, for batch row b, query head h (reading KV head h / rep) and query
// position i:
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h/rep]) v[b, j]
// over the keys j < Sk with j <= i (causal; the wrapper refuses anything else)
// and j > i - window (when a window is given). q is (B, Sq, nh, hd), k and v
// are (B, Sk, nkv, hd), read in that
// layout through their strides: no head-major copy and no pad copy. The ragged
// edges of Sq and Sk are masked here, where the reference's wrapper padded to
// block multiples. Keys past Sk are never attended, as in the reference oracle
// (ref.py::attention_ref).
//
// The arithmetic is the Pallas body's: f32 scores, f32 running max m (starting
// at -1e30), running sum l and accumulator; alpha = exp(m_prev - m_cur); p = 0
// where masked; a row that attends nothing (l == 0) writes 0.
//
// What bounds it on the card: arithmetic. Causal prefill does about
// 4 * hd * nh * (visible (query, key) pairs) flops per batch row and reads
// each input once, so at these shapes (hd 128-256, thousands of pairs per
// query tile) it sits far above the ~295 flop/byte ridge of an H100 in bf16.
// What this design does about it: one thread block per (query tile of 64,
// query head, batch row) keeps its 64 x hd query tile, one 64 x hd K tile and
// one V tile in shared memory as f32, and every thread holds a 4 x 4 block of
// scores and a 4 x (hd/16) block of the accumulator in registers, so each
// shared-memory load feeds several FMAs. The K-tile loop runs only over the
// tiles that hold a visible pair (the bounds are the same for every thread of
// the block, so none misses a barrier): up to the tile of the last query
// (causal) and from the tile of the first query's window start.
//
// What it leaves on the table, for later work (ROADMAP Queue 2 row 2): it
// multiplies on the f32 CUDA cores, not the tensor cores (no wgmma or mma.sync;
// bf16 inputs are widened at load), and it loads tiles with plain loads and
// barriers (no cp.async / TMA double buffering), so copies do not overlap
// math. At hd 256 the f32 tiles take 216 KB of shared memory: one block per SM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads over a 64 x 64 score tile
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per K tile
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 16 lanes that share a query row (a half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Row strides in floats: q and K tiles are padded by 4 so a thread's float4
// reads of 16 different rows spread over the banks; P is padded likewise.
template <int HD>
struct Smem {
  static constexpr int kQS = HD + 4;
  static constexpr int kPS = kBK + 4;
  static constexpr size_t kFloats =
      (size_t)kBQ * kQS + (size_t)kBK * kQS + (size_t)kBK * HD +
      (size_t)kBQ * kPS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Copy `rows` rows (row r at src + r * row_stride, hd contiguous elements)
// into shared memory as f32 with `dst_stride` floats between rows; rows at or
// past `valid` are zero-filled. Neighbouring threads read neighbouring
// elements of a row.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t row_stride, int rows,
                                          int valid, float* dst,
                                          int dst_stride) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    dst[r * dst_stride + d] =
        r < valid ? to_float(src[(int64_t)r * row_stride + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int nh, int rep, int64_t q_sb,
                           int64_t q_ss, int64_t q_sh, int64_t k_sb,
                           int64_t k_ss, int64_t k_sh, int64_t v_sb,
                           int64_t v_ss, int64_t v_sh, float scale,
                           int window) {
  using S = Smem<HD>;
  constexpr int kQS = S::kQS;
  constexpr int kPS = S::kPS;
  constexpr int kDD = HD / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * kQS;
  float* v_s = k_s + kBK * kQS;
  float* p_s = v_s + kBK * HD;

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / rep;
  const int ty = threadIdx.x / 16;  // query rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // keys tx + 16*jj, dims tx + 16*dd

  load_tile<T, HD>(q + b * q_sb + (int64_t)q_start * q_ss + h * q_sh, q_ss,
                   kBQ, Sq - q_start, q_s, kQS);
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  float m[4], l[4], acc[4][kDD];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDD; ++dd) acc[ii][dd] = 0.f;
  }

  // the K tiles that hold a visible pair for some query of this tile (the
  // attention is always causal: ops.py refuses causal=False, as the
  // reference's wrapper restricts it)
  const int q_last = min(q_start + kBQ, Sq) - 1;
  const int n_kt = (Sk + kBK - 1) / kBK;
  const int kt_end = min(n_kt, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q_start - window + 1 > 0)
    kt_begin = (q_start - window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the last tile's readers are done (and q_s is loaded)
    load_tile<T, HD>(kb + (int64_t)k_start * k_ss, k_ss, kBK, Sk - k_start,
                     k_s, kQS);
    load_tile<T, HD>(vb + (int64_t)k_start * v_ss, v_ss, kBK, Sk - k_start,
                     v_s, HD);
    __syncthreads();

    // scores: rows ty*4+ii, keys tx+16*jj
    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        qa[ii] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + ii) * kQS + d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        ka[jj] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * jj) * kQS + d);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float t = s[ii][jj];
          t = fmaf(qa[ii].x, ka[jj].x, t);
          t = fmaf(qa[ii].y, ka[jj].y, t);
          t = fmaf(qa[ii].z, ka[jj].z, t);
          t = fmaf(qa[ii].w, ka[jj].w, t);
          s[ii][jj] = t;
        }
    }

    // mask, online softmax, P into shared memory, rescale the accumulator
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qp = q_start + ty * 4 + ii;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k_start + tx + 16 * jj;
        ok[jj] = kp < Sk && kp <= qp && (window <= 0 || kp > qp - window);
        s[ii][jj] = ok[jj] ? s[ii][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[ii][jj]);
      }
      const float m_prev = m[ii];
      const float m_cur = fmaxf(m_prev, row_max(mx));
      const float alpha = expf(m_prev - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(s[ii][jj] - m_cur) : 0.f;
        sum += p;
        p_s[(ty * 4 + ii) * kPS + tx + 16 * jj] = p;
      }
      l[ii] = l[ii] * alpha + row_sum(sum);
      m[ii] = m_cur;
#pragma unroll
      for (int dd = 0; dd < kDD; ++dd) acc[ii][dd] *= alpha;
    }
    __syncthreads();

    // acc += P V: rows ty*4+ii, dims tx+16*dd
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        pa[ii] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + ii) * kPS + j);
#pragma unroll
      for (int dd = 0; dd < kDD; ++dd) {
        const float v0 = v_s[(j + 0) * HD + tx + 16 * dd];
        const float v1 = v_s[(j + 1) * HD + tx + 16 * dd];
        const float v2 = v_s[(j + 2) * HD + tx + 16 * dd];
        const float v3 = v_s[(j + 3) * HD + tx + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          float t = acc[ii][dd];
          t = fmaf(pa[ii].x, v0, t);
          t = fmaf(pa[ii].y, v1, t);
          t = fmaf(pa[ii].z, v2, t);
          t = fmaf(pa[ii].w, v3, t);
          acc[ii][dd] = t;
        }
      }
    }
  }

  // out is (B, Sq, nh, HD), contiguous
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qp = q_start + ty * 4 + ii;
    if (qp >= Sq) continue;
    T* o = out + (((int64_t)b * Sq + qp) * nh + h) * HD;
#pragma unroll
    for (int dd = 0; dd < kDD; ++dd)
      store(o + tx + 16 * dd, l[ii] > 0.f ? acc[ii][dd] / l[ii] : 0.f);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int nh, int nkv, const int64_t* strides,
              float scale, int window, cudaStream_t stream) {
  const size_t smem = Smem<HD>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, nh, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, nh, nh / nkv,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int nh, int nkv, int hd, const int64_t* strides,
           float scale, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, B, Sq, Sk, nh, nkv, strides,
                              scale, window, s);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, B, Sq, Sk, nh, nkv, strides,
                              scale, window, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, B, Sq, Sk, nh, nkv, strides,
                              scale, window, s);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, B, Sq, Sk, nh, nkv, strides,
                               scale, window, s);
    case 256:
      return launch_hd<T, 256>(q, k, v, out, B, Sq, Sk, nh, nkv, strides,
                               scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, nh, hd), k and v (B, Sk, nkv, hd) with the element strides
// strides = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h} (the last dim is
// contiguous); out (B, Sq, nh, hd) contiguous. hd in {16, 32, 64, 128, 256},
// nh % nkv == 0 (checked by ops.py). window <= 0 means no window. Launches on
// `stream` and returns a CUDA error code (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int nh,
                                   int nkv, int hd, const int64_t* strides,
                                   float scale, int window, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, nh, nkv, hd, strides, scale,
                       window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int nh, int nkv, int hd,
                                    const int64_t* strides, float scale,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, nh, nkv, hd, strides,
                               scale, window, stream);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
