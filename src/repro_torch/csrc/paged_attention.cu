// Paged-attention decode for Hopper (sm_90a): single-token attention read in
// place from the KV block pool.
//
// Replaces the TPU kernel kernels/paged_attention/kernel.py::_paged_attn_kernel
// of the JAX reference (launcher paged_attention_kernel, wrapper
// ops.paged_attention). Python side: repro_torch/kernels/paged_attention/
// (kernel.py binds these entry points, ops.py checks the arguments, ref.py is
// the plain PyTorch version this kernel is tested against).
//
// Computes, for slot b and query head n = h * rep + r (GQA: query heads
// h*rep .. h*rep+rep-1 read KV head h):
//   out[b, n] = sum_t softmax_t(scale * q[b, n] . k_t) * v_t
// over the positions t <= pos[b] of the slot's chain. Position t lives in
// pool row table[b, t / bs] at offset t % bs, so the causal mask needs no
// stored positions. Pages mapped to the reserved null block 0 are skipped.
// Scores, the running max m, the running sum l and the accumulator are f32,
// with the reference's -1e30 start, alpha = exp(m_prev - m_cur) and p = 0 for
// masked tokens. A row with no attendable token (an empty slot) writes zeros.
//
// What bounds it on the card: memory. A call must read each live K/V page
// once, about 2 * B * ceil((pos+1)/bs) * bs * nkv * hd * sizeof(T) bytes, and
// does about 4 flops per element it reads, far below the ~295 flop/byte at
// which an H100 stops being memory bound. What the design does about it:
// one thread block per (slot, KV head) reads each K/V row of its chain
// exactly once for the whole group of rep query heads that share it, with
// 16-byte vector loads, and fetches nothing past the causal frontier (tokens
// after pos[b], pages after pos[b] / bs, null pages). Scores, probabilities
// and the accumulator stay in shared memory and never touch device memory.
//
// Known weakness, left for later work: the grid has B * nkv blocks (64 at
// batch 8 with 8 KV heads, fewer than the card's 132 SMs), and each block
// walks its chain serially, a 32-token tile at a time, with no copy overlap.
// Splitting pages across blocks with a combine pass, and cp.async / TMA
// double buffering, are the planned redesign.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;          // tokens per shared-memory tile = warp width
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy `rows` rows of `hd` elements (consecutive rows `src_stride` elements
// apart) into shared memory as f32, rows `dst_stride` floats apart. Each
// thread issues 16-byte loads; neighbouring threads read neighbouring bytes.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          size_t src_stride, int rows, int hd,
                                          float* dst, int dst_stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = hd / kVec;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * src_stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * dst_stride + c;
#pragma unroll
    for (int k = 0; k < kVec; ++k) d[k] = to_float(e[k]);
  }
}

// Shared memory, in floats: q (rep*hd), K tile (kTile*(hd+1), padded so the
// per-token dot products hit distinct banks), V tile (kTile*hd), scores and
// probabilities (rep*kTile), accumulator (rep*hd), m, l, alpha (rep each).
size_t smem_bytes(int rep, int hd) {
  return sizeof(float) *
         ((size_t)2 * rep * hd + (size_t)kTile * (hd + 1) +
          (size_t)kTile * hd + (size_t)rep * kTile + (size_t)3 * rep);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ kpool,
                           const T* __restrict__ vpool,
                           const int* __restrict__ table,
                           const int* __restrict__ pos, T* __restrict__ out,
                           int nkv, int rep, int hd, int bs, int nb,
                           int n_pool, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / nkv;
  const int h = blockIdx.x - b * nkv;
  const int nh = nkv * rep;
  const int ks = hd + 1;
  float* q_s = smem;
  float* k_s = q_s + rep * hd;
  float* v_s = k_s + kTile * ks;
  float* p_s = v_s + kTile * hd;
  float* acc_s = p_s + rep * kTile;
  float* m_s = acc_s + rep * hd;
  float* l_s = m_s + rep;
  float* a_s = l_s + rep;

  // the group's rep query rows are contiguous in q (B, nh, hd)
  const size_t group = ((size_t)b * nh + (size_t)h * rep) * hd;
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
    q_s[i] = to_float(q[group + i]);
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rep; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  const int n_pages = p < 0 ? 0 : min(p / bs + 1, nb);
  const size_t token_stride = (size_t)nkv * hd;  // elements between tokens
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;

  for (int j = 0; j < n_pages; ++j) {
    const int blk = table[(size_t)b * nb + j];
    // null page (and, defensively, an id outside the pool): nothing to
    // attend. Uniform across the block, so no thread misses a barrier.
    if (blk <= 0 || blk >= n_pool) continue;
    const size_t page = ((size_t)blk * bs * nkv + h) * hd;
    for (int t0 = 0; t0 < bs; t0 += kTile) {
      // attendable tokens in this tile: inside the page and <= pos
      const int n = min(min(kTile, bs - t0), p - (j * bs + t0) + 1);
      if (n <= 0) break;
      const size_t tile = page + (size_t)t0 * token_stride;
      load_rows(kpool + tile, token_stride, n, hd, k_s, ks);
      load_rows(vpool + tile, token_stride, n, hd, v_s, hd);
      __syncthreads();

      // scores: one thread per (query row, token)
      for (int i = threadIdx.x; i < rep * n; i += blockDim.x) {
        const int r = i / n;
        const int o = i - r * n;
        const float* qr = q_s + r * hd;
        const float* kr = k_s + o * ks;
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        p_s[r * kTile + o] = s * scale;
      }
      __syncthreads();

      // online softmax: one warp per query row, one token per lane
      for (int r = warp; r < rep; r += n_warps) {
        const float s = lane < n ? p_s[r * kTile + lane] : kNegInf;
        const float m_prev = m_s[r];
        const float m_cur = fmaxf(m_prev, warp_max(s));
        const float e = lane < n ? expf(s - m_cur) : 0.f;
        const float sum = warp_sum(e);
        p_s[r * kTile + lane] = e;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_cur);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_cur;
        }
      }
      __syncthreads();

      // accumulator: one thread per (query row, dim)
      for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
        const int r = i / hd;
        const int d = i - r * hd;
        const float* pr = p_s + r * kTile;
        float acc = acc_s[i] * a_s[r];
        for (int o = 0; o < n; ++o) acc = fmaf(pr[o], v_s[o * hd + d], acc);
        acc_s[i] = acc;
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
    const float l = l_s[i / hd];
    store(out + group + i, l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* table, const void* pos, void* out, int B, int nh,
           int nkv, int hd, int bs, int nb, int n_pool, float scale,
           void* stream) {
  const int rep = nh / nkv;
  const size_t smem = smem_bytes(rep, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<T><<<B * nkv, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), nkv, rep, hd, bs,
      nb, n_pool, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, nh, hd); kpool, vpool (n_pool, bs, nkv, hd); table (B, nb) int32;
// pos (B,) int32; out (B, nh, hd). All contiguous, q/kpool/vpool 16-byte
// aligned, hd in {16, 32, 64, 128}, nh % nkv == 0 (checked by ops.py).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* kpool,
                                   const void* vpool, const void* table,
                                   const void* pos, void* out, int B, int nh,
                                   int nkv, int hd, int bs, int nb,
                                   int n_pool, float scale, void* stream) {
  return launch<float>(q, kpool, vpool, table, pos, out, B, nh, nkv, hd, bs,
                       nb, n_pool, scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* kpool,
                                    const void* vpool, const void* table,
                                    const void* pos, void* out, int B, int nh,
                                    int nkv, int hd, int bs, int nb,
                                    int n_pool, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kpool, vpool, table, pos, out, B, nh, nkv,
                               hd, bs, nb, n_pool, scale, stream);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
