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
// are (B, Sk, nkv, hd), read in that layout through their strides: no
// head-major copy and no pad copy. The ragged edges of Sq and Sk are masked
// here, where the reference's wrapper padded to block multiples. Keys past Sk
// are never attended, as in the reference oracle (ref.py::attention_ref).
//
// The arithmetic is the Pallas body's: f32 scores, f32 running max m (starting
// at -1e30), running sum l and accumulator; alpha = exp(m_prev - m_cur); p = 0
// where masked; a row that attends nothing (l == 0) writes 0.
//
// What bounds it on the card: arithmetic. Causal prefill does about
// 4 * hd * nh * (visible (query, key) pairs) flops per batch row and reads
// each input once, so at these shapes (hd 128-256, thousands of pairs per
// query tile) it sits far above the ~295 flop/byte ridge of an H100 in bf16.
//
// Two templates, chosen by dtype:
//
// * bf16 -> flash_attention_mma<HD>, on the tensor cores. A block takes 64
//   query rows of one (query head, batch row) with two halves of 4 warps,
//   each warp 16 rows; the query tiles with the most K tiles are launched
//   first. The two halves split the block's K tiles between them (half i
//   takes tiles i, i + 2, ...), each with its own Q copy, K/V stages and
//   named barrier, and merge their (m, l, O) in half order at the end: the
//   chain of K tiles a block walks is half as long, which is what a causal
//   prefill's longest blocks wait on. (One half per block, as a second
//   block shape, was slower at 8 of 10 shapes on an H100, up to 1.58x at
//   hd 16, and faster only at a 64-token prompt and at batch 4: PERF.md,
//   PR 14.) Q, K and V tiles stay bf16 in shared memory, rows padded by 16
//   bytes so that ldmatrix reads 8 rows without bank conflicts. S = Q K^T
//   and O += P V run as mma.sync.m16n8k16 bf16 -> f32 with operands from
//   ldmatrix (.trans for V); Q is read from shared memory at every k-step
//   rather than held in registers, so that at hd 256 a thread keeps only its
//   128 accumulator floats, 16 scores and its m and l (ptxas: 242 registers
//   at hd 256, 166 at hd 128, no spill). The softmax is FA2's online form in
//   f32 on the mma accumulators, in base 2 with the scale folded into one
//   FFMA; a masked score is -inf, so its p is exactly 0, and only a tile
//   that crosses the diagonal, the window edge or Sk takes the mask branch;
//   the accumulator is rescaled only when a row's max moved. P is rounded to
//   bf16 for the P V product (l sums the unrounded p). K and V tiles are
//   double-buffered with 16-byte cp.async.cg (zero-filled past Sk), K and V
//   in separate commit groups, so the next K tile streams in during this
//   tile's P V and V during this tile's Q K^T. K tiles are 64 keys (32 at
//   hd 256, where a block's shared memory is 2 x 99 KB). 16-byte copies
//   need 16-byte-aligned rows: ops.py refuses bf16 strides that are not
//   multiples of 8 elements and base pointers that are not 16-byte aligned.
// * f32 -> flash_attention_simt<HD>, on the CUDA cores, the first design.
//   The tensor cores take f32 only as TF32, which keeps ~3 decimal digits
//   and would break the 2e-5 f32 tolerance and the f32 "pallas"-against-
//   "xla" model checks. One block of 256 threads per 64 query rows keeps the
//   query tile, one K and one V tile in shared memory as f32; every thread
//   holds a 4 x 4 block of scores and a 4 x (hd/16) block of the
//   accumulator in registers.
//
// Both share the mask (visible()) and the K-tile loop bounds (k_tiles()): the
// loop runs only over the tiles that hold a visible pair for some query of
// the block (bounds uniform over the block, so no thread misses a barrier):
// up to the tile of the last query (causal) and from the tile of the first
// query's window start.
//
// What bounds the bf16 template now: instruction throughput. mma.sync is a
// small part of the loop's instructions (the rest: ldmatrix, softmax,
// copies, address arithmetic), every warp reads each K and V tile
// from shared memory itself, and all threads wait on the copies. Hopper's
// wgmma (operands straight from shared memory, 64-row warpgroup tiles), TMA
// tile copies and a warp-specialised producer are the next design (ROADMAP
// Queue 2 row 2). The f32 template stays on the CUDA cores, with plain loads
// and no copy overlap.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF

// ------------------------------------------------ shared by both templates

// key kp is visible from query qp
__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int window) {
  return kp < Sk && kp <= qp && (window <= 0 || kp > qp - window);
}

// [begin, end): the K tiles of `bk` keys that hold a visible pair for some
// query in [q_start, q_last] (the attention is always causal: ops.py refuses
// causal=False, as the reference's wrapper restricts it)
__device__ __forceinline__ void k_tiles(int q_start, int q_last, int Sk,
                                        int window, int bk, int* begin,
                                        int* end) {
  const int n_kt = (Sk + bk - 1) / bk;
  *end = min(n_kt, q_last / bk + 1);
  *begin = 0;
  if (window > 0 && q_start - window + 1 > 0)
    *begin = (q_start - window + 1) / bk;
}

// ------------------------------------------ f32: CUDA cores (simt template)

namespace simt {

constexpr int kThreads = 256;      // 16 x 16 threads over a 64 x 64 score tile
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per K tile

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

// Copy `rows` rows (row r at src + r * row_stride, hd contiguous floats)
// into shared memory with `dst_stride` floats between rows; rows at or past
// `valid` are zero-filled. Neighbouring threads read neighbouring elements.
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t row_stride, int rows,
                                          int valid, float* dst,
                                          int dst_stride) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    dst[r * dst_stride + d] = r < valid ? src[(int64_t)r * row_stride + d]
                                        : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_simt(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
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

  load_tile<HD>(q + b * q_sb + (int64_t)q_start * q_ss + h * q_sh, q_ss,
                kBQ, Sq - q_start, q_s, kQS);
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  float m[4], l[4], acc[4][kDD];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = kNegInf;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDD; ++dd) acc[ii][dd] = 0.f;
  }

  int kt_begin, kt_end;
  k_tiles(q_start, min(q_start + kBQ, Sq) - 1, Sk, window, kBK, &kt_begin,
          &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * kBK;
    __syncthreads();  // the last tile's readers are done (and q_s is loaded)
    load_tile<HD>(kb + (int64_t)k_start * k_ss, k_ss, kBK, Sk - k_start, k_s,
                  kQS);
    load_tile<HD>(vb + (int64_t)k_start * v_ss, v_ss, kBK, Sk - k_start, v_s,
                  HD);
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
        ok[jj] = visible(qp, k_start + tx + 16 * jj, Sk, window);
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
    float* o = out + (((int64_t)b * Sq + qp) * nh + h) * HD;
#pragma unroll
    for (int dd = 0; dd < kDD; ++dd)
      o[tx + 16 * dd] = l[ii] > 0.f ? acc[ii][dd] / l[ii] : 0.f;
  }
}

}  // namespace simt

// ------------------------------------------ bf16: tensor cores (mma template)

namespace mma {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // a half: 4 warps x 16 query rows
constexpr int kHalves = 2;     // halves per block, splitting its K tiles
constexpr int kBQ = 64;        // query rows per block
constexpr float kLog2e = 1.4426950408889634f;
using namespace sm90;  // cp.async, ldmatrix, mma.sync (mma_sm90.cuh)

template <int HD>
struct Cfg {
  static constexpr int kBK = HD >= 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStride = HD + 8;  // bf16 per smem row: +16 bytes
  // one half's shared memory: its Q tile, then two stages each of K and V
  static constexpr int kHalfElems = (kBQ + 4 * kBK) * kStride;
};

// ROWS rows of HD bf16 (row r at src + r * row_stride) into shared memory
// rows HD + 8 apart, 16 bytes per cp.async, by the 128 threads of one half;
// rows at or past `valid` are zero-filled. Neighbouring threads copy
// neighbouring 16-byte chunks.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int64_t row_stride, int valid,
                                                bf16* dst) {
  constexpr int kChunks = HD / 8;
  constexpr int kStep = kThreads / kChunks;  // rows between a thread's copies
  static_assert((ROWS * kChunks) % kThreads == 0, "tile must split evenly");
  const int tid = threadIdx.x % kThreads;  // this thread in its half
  const int r0 = tid / kChunks;
  const int col = (tid % kChunks) * 8;
  const bf16* g = src + (int64_t)r0 * row_stride + col;
  uint32_t s = smem_addr(dst + r0 * (HD + 8) + col);
#pragma unroll
  for (int r = r0; r < ROWS; r += kStep) {
    cp_async16(s, r < valid ? g : src, r < valid);
    g += kStep * row_stride;
    s += kStep * (HD + 8) * sizeof(bf16);
  }
}

// the barrier of one half: its own named barrier (1 or 2), 128 threads
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(half + 1), "n"(kThreads)
               : "memory");
}

// Two halves of 4 warps each take the same 64 query rows; half i walks the
// block's K tiles i, i + 2, i + 4, ... with its own Q copy, K/V stages and
// barrier, and the halves' (m, l, O) are merged in half order at the end.
template <int HD>
__global__ void __launch_bounds__(kThreads * kHalves)
    flash_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        int Sq, int Sk, int nh, int rep, int64_t q_sb,
                        int64_t q_ss, int64_t q_sh, int64_t k_sb,
                        int64_t k_ss, int64_t k_sh, int64_t v_sb,
                        int64_t v_ss, int64_t v_sh, float scale, int window) {
  constexpr int kBK = Cfg<HD>::kBK;
  constexpr int kS = Cfg<HD>::kStride;
  constexpr int kNT = kBK / 8;  // n8 score tiles per warp
  constexpr int kDT = HD / 8;   // n8 accumulator tiles per warp
  extern __shared__ uint4 smem_u4[];
  const int half = threadIdx.x / kThreads;
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4) + half * Cfg<HD>::kHalfElems;
  bf16* k_s = q_s + kBQ * kS;      // stages 0 and 1
  bf16* v_s = k_s + 2 * kBK * kS;  // stages 0 and 1

  // the query tiles with the most K tiles first (causal: the last ones)
  const int q_start = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / rep;
  const int warp = (threadIdx.x % kThreads) / 32;
  const int lane = threadIdx.x % 32;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  int kt_begin, kt_end;
  k_tiles(q_start, min(q_start + kBQ, Sq) - 1, Sk, window, kBK, &kt_begin,
          &kt_end);
  const int kt0 = kt_begin + half;  // this half's first tile

  // copy groups, per thread, are committed in tile order, K then V, one
  // group each (empty past the half's last tile, so the counts below hold):
  // {Q, K of the first tile}, {its V}; each tile then commits the next K
  // once its own K is in, and the next V once its own V is in, each into
  // the stage the previous tile has finished with.
  load_tile_async<kBQ, HD>(q + b * q_sb + (int64_t)q_start * q_ss + h * q_sh,
                           q_ss, Sq - q_start, q_s);
  if (kt0 < kt_end)
    load_tile_async<kBK, HD>(kb + (int64_t)kt0 * kBK * k_ss, k_ss,
                             Sk - kt0 * kBK, k_s);
  cp_async_commit();
  if (kt0 < kt_end)
    load_tile_async<kBK, HD>(vb + (int64_t)kt0 * kBK * v_ss, v_ss,
                             Sk - kt0 * kBK, v_s);
  cp_async_commit();

  // this thread's rows of the warp's 16: r0 and r0 + 8 (mma C layout)
  const int w0 = q_start + warp * 16;
  const int r0 = w0 + lane / 4;
  const float sl2 = scale * kLog2e;  // softmax in base 2
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // ldmatrix row addresses, per lane (see the fragment layouts of
  // mma.m16n8k16): Q rows for the A operand, K rows for B, V rows for B^T
  const uint32_t q_lane =
      smem_addr(q_s + (warp * 16 + lane % 16) * kS + (lane / 16) * 8);
  const int k_lane = (lane % 8 + (lane / 16) * 8) * kS + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 8 + ((lane / 8) % 2) * 8) * kS + (lane / 16) * 8;

  for (int kt = kt0; kt < kt_end; kt += kHalves) {
    const int st = ((kt - kt0) / kHalves) & 1;
    const int k_start = kt * kBK;
    const bf16* ks = k_s + st * kBK * kS;
    const bf16* vs = v_s + st * kBK * kS;
    const int nxt = kt + kHalves;  // the half's next tile, other stage

    cp_async_wait<1>();  // this K tile (and Q) landed; V may be in flight
    half_sync(half);  // ... for the whole half; the last K reads are done
    if (nxt < kt_end)
      load_tile_async<kBK, HD>(kb + (int64_t)nxt * kBK * k_ss, k_ss,
                               Sk - nxt * kBK, k_s + (st ^ 1) * kBK * kS);
    cp_async_commit();

    // S = Q K^T: 16 rows x kBK keys per warp
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(q_lane + kk * 32, a);
#pragma unroll
      for (int nn = 0; nn < kNT / 2; ++nn) {
        uint32_t bb[4];
        ldmatrix_x4(smem_addr(ks + nn * 16 * kS + k_lane + kk * 16), bb);
        mma_16816(s[2 * nn], a, bb[0], bb[1]);
        mma_16816(s[2 * nn + 1], a, bb[2], bb[3]);
      }
    }

    // mask, only in a tile that crosses the diagonal, the window edge or Sk
    // (a branch uniform over the warp): a masked score is -inf, so its
    // p = exp2(-inf) is exactly 0 and it never raises the running max, which
    // starts at the reference's -1e30
    const bool full = k_start + kBK <= Sk && k_start + kBK - 1 <= w0 &&
                      (window <= 0 || k_start > w0 + 15 - window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(r0 + (e / 2) * 8,
                       k_start + j * 8 + (lane % 4) * 2 + e % 2, Sk, window))
            s[j][e] = -INFINITY;
    }
    // online softmax in base 2 on the raw scores: max(s) * c is the max of
    // s * c for the scale c > 0, and p = exp2(s * c - m) is one FFMA and
    // one MUFU
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float alpha[2], nm[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 4 lanes share lane / 4
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_cur = fmaxf(m[i], mx[i] * sl2);
      alpha[i] = exp2f(m[i] - m_cur);
      m[i] = m_cur;
      nm[i] = -m_cur;
    }
    // P in bf16, packed as the A operand of P V: the C layout of score
    // tiles 2kk and 2kk+1 is the A layout of k-step kk
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(s[j][e], sl2, nm[e / 2]));
        rs[e / 2] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // lane part
    // rescale the accumulator, unless no row of the warp moved its max
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int d = 0; d < kDT; ++d) {
        o[d][0] *= alpha[0];
        o[d][1] *= alpha[0];
        o[d][2] *= alpha[1];
        o[d][3] *= alpha[1];
      }
    }

    cp_async_wait<1>();  // this V tile landed; the next K may be in flight
    half_sync(half);  // ... for the whole half; the last V reads are done
    if (nxt < kt_end)
      load_tile_async<kBK, HD>(vb + (int64_t)nxt * kBK * v_ss, v_ss,
                               Sk - nxt * kBK, v_s + (st ^ 1) * kBK * kS);
    cp_async_commit();

    // O += P V, V^T fragments by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int dd = 0; dd < HD / 16; ++dd) {
        uint32_t bb[4];
        ldmatrix_x4_trans(smem_addr(vs + kk * 16 * kS + v_lane + dd * 16), bb);
        mma_16816(o[2 * dd], pa[kk], bb[0], bb[1]);
        mma_16816(o[2 * dd + 1], pa[kk], bb[2], bb[3]);
      }
  }
  cp_async_wait<0>();  // nothing in flight when the block ends
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // l summed over a row's 4 lanes
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // half 1 hands its (m, l, O) over through its own shared memory, each
  // value where the same thread of half 0 (same rows and columns) reads
  // it; half 0 folds it into its own: M = max, weights exp2(m - M)
  __syncthreads();
  const int tid = threadIdx.x % kThreads;
  float* xs = reinterpret_cast<float*>(reinterpret_cast<bf16*>(smem_u4) +
                                       Cfg<HD>::kHalfElems);
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      xs[i * kThreads + tid] = m[i];
      xs[(2 + i) * kThreads + tid] = l[i];
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xs[(4 + d * 4 + e) * kThreads + tid] = o[d][e];
  }
  __syncthreads();
  if (half == 1) return;
  float a0[2], a1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xs[i * kThreads + tid];
    const float mm = fmaxf(m[i], m1);
    a0[i] = exp2f(m[i] - mm);
    a1[i] = exp2f(m1 - mm);
    l[i] = l[i] * a0[i] + xs[(2 + i) * kThreads + tid] * a1[i];
  }
#pragma unroll
  for (int d = 0; d < kDT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[d][e] = o[d][e] * a0[e / 2] +
                xs[(4 + d * 4 + e) * kThreads + tid] * a1[e / 2];

  // finalize: 1/l, or 0 for a row that attended nothing. The warp stages
  // its 16 bf16 rows in its own rows of q_s (only this warp read them) and
  // stores them as 16-byte chunks.
  bf16* stage = q_s + warp * 16 * kS;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* row = stage + (lane / 4 + 8 * i) * kS + (lane % 4) * 2;
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(row + d * 8) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
  }
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int qp = w0 + r;
    if (qp < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + qp) * nh + h) * HD +
                                col) =
          *reinterpret_cast<const uint4*>(stage + r * kS + col);
  }
}

}  // namespace mma

// ------------------------------------------------------------ launchers

template <typename T>
struct Kernel;

template <>
struct Kernel<float> {
  template <int HD>
  static int launch(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int nh, int nkv,
                    const int64_t* st, float scale, int window,
                    cudaStream_t stream) {
    const size_t smem = simt::Smem<HD>::kBytes;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          simt::flash_attention_simt<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((Sq + simt::kBQ - 1) / simt::kBQ, nh, B);
    simt::flash_attention_simt<HD><<<grid, simt::kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, nh,
        nh / nkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], scale, window);
    return (int)cudaGetLastError();
  }
};

template <>
struct Kernel<__nv_bfloat16> {
  template <int HD>
  static int launch(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int nh, int nkv,
                    const int64_t* st, float scale, int window,
                    cudaStream_t stream) {
    using mma::bf16;
    const size_t smem =
        (size_t)mma::kHalves * mma::Cfg<HD>::kHalfElems * sizeof(bf16);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          mma::flash_attention_mma<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((Sq + mma::kBQ - 1) / mma::kBQ, nh, B);
    mma::flash_attention_mma<HD>
        <<<grid, mma::kThreads * mma::kHalves, smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, nh,
            nh / nkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
            st[7], st[8], scale, window);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int nh, int nkv, int hd, const int64_t* strides,
           float scale, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return Kernel<T>::template launch<16>(q, k, v, out, B, Sq, Sk, nh, nkv,
                                            strides, scale, window, s);
    case 32:
      return Kernel<T>::template launch<32>(q, k, v, out, B, Sq, Sk, nh, nkv,
                                            strides, scale, window, s);
    case 64:
      return Kernel<T>::template launch<64>(q, k, v, out, B, Sq, Sk, nh, nkv,
                                            strides, scale, window, s);
    case 128:
      return Kernel<T>::template launch<128>(q, k, v, out, B, Sq, Sk, nh, nkv,
                                             strides, scale, window, s);
    case 256:
      return Kernel<T>::template launch<256>(q, k, v, out, B, Sq, Sk, nh, nkv,
                                             strides, scale, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, nh, hd), k and v (B, Sk, nkv, hd) with the element strides
// strides = {q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h} (the last dim is
// contiguous; for bf16 every stride a multiple of 8 and every base pointer
// 16-byte aligned); out (B, Sq, nh, hd) contiguous. hd in {16, 32, 64, 128,
// 256}, nh % nkv == 0 (checked by ops.py). window <= 0 means no window.
// Launches on `stream` and returns a CUDA error code (0 = launched).
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
