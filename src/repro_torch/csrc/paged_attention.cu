// Paged-attention decode for Hopper (sm_90a): single-token attention read in
// place from the KV block pool, with each page chain split across blocks
// (flash-decoding) and a second pass that combines the splits.
//
// Replaces the TPU kernel kernels/paged_attention/kernel.py::_paged_attn_kernel
// of the JAX reference (launcher paged_attention_kernel, wrapper
// ops.paged_attention). Python side: repro_torch/kernels/paged_attention/
// (kernel.py binds these entry points, ops.py checks the arguments and plans
// the splits, ref.py holds the plain PyTorch version this kernel is tested
// against and its two-pass twin paged_attention_split_ref).
//
// Computes, for slot b and query head n = h * rep + r (GQA: query heads
// h*rep .. h*rep+rep-1 read KV head h):
//   out[b, n] = sum_t softmax_t(scale * q[b, n] . k_t) * v_t
// over the positions t <= pos[b] of the slot's chain. Position t lives in
// pool row table[b, t / bs] at offset t % bs, so the causal mask needs no
// stored positions. Pages after pos[b] / bs, pages mapped to the reserved
// null block 0 and ids >= n_pool are skipped. Scores, the running max m, the
// running sum l and the accumulator are f32, with the reference's -1e30
// start, alpha = exp(m_prev - m_cur) and p = 0 for masked tokens. A row with
// no attendable token (an empty slot) writes exact zeros.
//
// What bounds it on the card: memory. A call must read each live K/V page
// once, about 2 * B * (pos+1) * nkv * hd * sizeof(T) bytes, and does about 4
// flops per element it reads, far below the ~295 flop/byte at which an H100
// stops being memory bound. So the card needs many bytes in flight on every
// SM at once, and nothing that serialises a block. What the design does:
//
// * Pass 1, paged_attention_split: a grid of (split, KV head x head group,
//   slot) blocks of 4 warps. ops.split_plan picks the splits from (B, nkv,
//   nb, bs) alone, never from the pool or the positions: split s owns pages
//   [s * pps, (s+1) * pps) of every chain, and the count aims at about 4
//   blocks per SM (512 at the main shape: batch 8, 8 KV heads, 8 splits of 4
//   pages), which keeps the whole K/V stream of a decode step in flight at
//   once. The warps take the split's positions in batches of 8 rows (16 at
//   hd 16 in bf16): each lane loads its 16-byte chunk of every row of the
//   batch, K and V, straight into registers, and the next batch's loads go
//   out before this one is reduced; the lane keeps its chunk of the group's
//   query rows in registers too. The page ids are read without waiting for
//   pos. The lanes of a row reduce its dot products with warp shuffles; the
//   online softmax and the accumulator update run in registers, with no
//   barrier inside the loop. A row past pos, on a null page or on an id >=
//   n_pool is not read. A block serves up to 4 query heads of its KV head,
//   reading each K/V row once for all of them (every config's rep is at most
//   4 but starcoder2-7b's 9, whose KV heads get ceil(rep / 4) head groups
//   that read the rows again, mostly from L2). At the end the 4 warps fold
//   their partials in warp order through shared memory, and the block writes
//   its f32 partial (acc, m, l) to scratch that the wrapper allocates; a
//   split with nothing to attend leaves (m = -1e30, l = 0, acc = 0).
// * Pass 2, paged_attention_combine: one thread per output element folds
//   the splits of its (slot, head) in split order, 8 splits' loads at a
//   time: M = max m_s, out = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M)
//   l_s, or 0 where the sum of l is 0. It is a programmatic dependent
//   launch: scheduled while pass 1 runs, it waits (griddepcontrol.wait) for
//   pass 1's partials, which hides the gap between the launches. No atomics
//   go into any sum: the output is bitwise the same on every call, and
//   poison in rows that are not attended moves no bit of it.
//
// What bounds it now: the chain before the first byte (pos and the page
// ids, then the rows) and the tail after the last (every warp of an SM
// reduces at once when the data lands, then the block fold, then pass 2).
// TMA page gathers into a shared-memory ring fed by a producer warp, so
// that reduction overlaps the stream, and the combine folded into the last
// block of each (slot, head) are the next design (ROADMAP Queue 2 row 1).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference kernel's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// element j of a 16-byte vector of T, as f32
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int j) {
  return to_float(reinterpret_cast<const T*>(&v)[j]);
}

// Start the loads of one batch: rows t0, t0 + RPW, ... (this lane's row in
// each warp-wide load), this lane's 16-byte chunk c of each, K and V. The
// page id is read whether or not the row is attendable, so that its load
// does not wait for pos's; a row that is not attendable (t >= last, a null
// page, an id >= n_pool) is not read and holds zeros.
template <typename T, int HD, int U, int RPW>
__device__ __forceinline__ void load_batch(const T* __restrict__ kpool,
                                           const T* __restrict__ vpool,
                                           const int* __restrict__ tbl,
                                           int t0, int last, int bs, int nb,
                                           int nkv, int h, int n_pool, int c,
                                           uint4 (&kr)[U], uint4 (&vr)[U],
                                           bool (&ok)[U]) {
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u * RPW;
    const int blk = tbl[min(t / bs, nb - 1)];
    ok[u] = t < last && blk > 0 && blk < n_pool;
    kr[u] = make_uint4(0, 0, 0, 0);
    vr[u] = make_uint4(0, 0, 0, 0);
    if (ok[u]) {
      const size_t off =
          (((size_t)blk * bs + t % bs) * nkv + h) * HD + c * kVec;
      kr[u] = *reinterpret_cast<const uint4*>(kpool + off);
      vr[u] = *reinterpret_cast<const uint4*>(vpool + off);
    }
  }
}

// Pass 1. Block (split, KV head x head group, slot); its 4 warps take the
// split's positions in batches of kRows rows, batch i to warp i % 4. R is
// the most query heads a block serves (1, 2 or 4): a KV head with rep > 4
// query heads gets ceil(rep / 4) head groups.
template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split(const T* __restrict__ q,
                          const T* __restrict__ kpool,
                          const T* __restrict__ vpool,
                          const int* __restrict__ table,
                          const int* __restrict__ positions,
                          float* __restrict__ acc_out,
                          float* __restrict__ ml_out, int nkv, int rep,
                          int bs, int nb, int n_pool, int n_splits, int pps,
                          float scale) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kLPR = HD / kVec;       // lanes per K/V row
  constexpr int kRPW = 32 / kLPR;       // rows per warp-wide load
  constexpr int kU = kRPW >= 8 ? 1 : 8 / kRPW;  // loads per lane per batch
  constexpr int kRows = kU * kRPW;      // rows per batch: 8 (16 at hd 16)
  __shared__ float m_s[kWarps][R], l_s[kWarps][R];
  __shared__ float acc_s[kWarps][R][HD];

  // let pass 2 launch now; it waits for this grid to finish before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x;
  const int groups = (rep + R - 1) / R;
  const int h = blockIdx.y / groups;
  const int r0 = (blockIdx.y - h * groups) * R;  // first head of the group
  const int nr = min(R, rep - r0);               // heads in the group
  const int b = blockIdx.z;
  const int nh = nkv * rep;
  const int pos = positions[b];
  const int n_pages = pos < 0 ? 0 : min(pos / bs + 1, nb);
  // this split's positions: [first, last), at most up to pos. The batches
  // walk the split's whole page run, a bound that does not wait for pos;
  // rows at or past `last` are masked and never read.
  const int first = split * pps * bs;
  const int last = min(min((split + 1) * pps, n_pages) * bs, pos + 1);
  const int span = min((split + 1) * pps, nb) * bs - first;
  const int n_batches = span > 0 ? (span + kRows - 1) / kRows : 0;
  const int* tbl = table + (size_t)b * nb;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rl = lane / kLPR;  // this lane's row in a warp-wide load
  const int c = lane % kLPR;   // ... and its 16-byte chunk of that row

  // the group's query rows are contiguous in q (B, nh, hd): this lane keeps
  // its chunk of each in registers
  const size_t q_row = (size_t)b * nh + (size_t)h * rep + r0;
  float qf[R][kVec];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < nr)
      raw = *reinterpret_cast<const uint4*>(q + (q_row + r) * HD + c * kVec);
#pragma unroll
    for (int j = 0; j < kVec; ++j) qf[r][j] = elem<T>(raw, j);
  }
  float m[R], l[R], acc[R][kVec];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;
  }

  // every row of a batch straight into registers, 16 bytes a lane; the
  // next batch's loads go out before this one is reduced. A row past `last`
  // or on a skipped page is not read.
  uint4 kn[kU], vn[kU];
  bool okn[kU];
  load_batch<T, HD, kU, kRPW>(kpool, vpool, tbl, first + warp * kRows + rl,
                              last, bs, nb, nkv, h, n_pool, c, kn, vn, okn);
  for (int bt = warp; bt < n_batches; bt += kWarps) {
    uint4 kr[kU], vr[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
      ok[u] = okn[u];
    }
    if (bt + kWarps < n_batches)
      load_batch<T, HD, kU, kRPW>(kpool, vpool, tbl,
                                  first + (bt + kWarps) * kRows + rl, last,
                                  bs, nb, nkv, h, n_pool, c, kn, vn, okn);
    // scores: the kLPR lanes of a row reduce its dot products, each K
    // element converted once for all the group's heads
    float sc[R][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kf[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) kf[j] = elem<T>(kr[u], j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot = fmaf(qf[r][j], kf[j], dot);
#pragma unroll
        for (int o = kLPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[r][u] = ok[u] ? dot * scale : kNegInf;
      }
    }
    // online softmax over the batch's rows (across the row lanes)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, sc[r][u]);
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_cur = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_cur);
      m[r] = m_cur;
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sc[r][u] = ok[u] ? expf(sc[r][u] - m_cur) : 0.f;
        ps += sc[r][u];
      }
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] *= alpha;
    }
    // this lane's chunk of the accumulator, over its own rows, each V
    // element converted once
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vf[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) vf[j] = elem<T>(vr[u], j);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          acc[r][j] = fmaf(sc[r][u], vf[j], acc[r][j]);
    }
  }

  // the warp's partial: sum the accumulator over its row lanes
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int o = kLPR; o < 32; o <<= 1)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  if (rl == 0)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc_s[warp][r][c * kVec + j] = acc[r][j];
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  __syncthreads();

  // the block's partial: the 4 warps folded in warp order, written as this
  // split's acc (B, nh, n_splits, HD) and (m, l) (B, nh, n_splits, 2)
  for (int i = threadIdx.x; i < nr * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w][r] - M);
      L = fmaf(l_s[w][r], e, L);
      A = fmaf(acc_s[w][r][d], e, A);
    }
    const size_t part = (q_row + r) * n_splits + split;
    acc_out[part * HD + d] = A;
    if (d == 0) {
      ml_out[part * 2] = M;
      ml_out[part * 2 + 1] = L;
    }
  }
}

// Pass 2: one thread per element of out (rows = B * nh, HD wide) folds the
// n_splits partials of its row in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine(const float* __restrict__ acc,
                            const float* __restrict__ ml, T* __restrict__ out,
                            int rows, int hd, int n_splits) {
  // launched early (programmatic dependent launch): wait here until pass 1
  // has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * hd) return;
  const int row = e / hd;
  const int d = e - row * hd;
  const float* mlr = ml + (size_t)row * n_splits * 2;
  const float* ar = acc + (size_t)row * n_splits * hd + d;
  // 8 splits a round: their loads go out together, then the fold, in split
  // order, rescales what came before to the new max
  float M = kNegInf, L = 0.f, O = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += 8) {
    float mv[8], lv[8], av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool in = s0 + i < n_splits;
      mv[i] = in ? mlr[2 * (s0 + i)] : kNegInf;
      lv[i] = in ? mlr[2 * (s0 + i) + 1] : 0.f;
      av[i] = in ? ar[(size_t)(s0 + i) * hd] : 0.f;
    }
    float Mc = M;
#pragma unroll
    for (int i = 0; i < 8; ++i) Mc = fmaxf(Mc, mv[i]);
    const float sc = expf(M - Mc);
    L *= sc;
    O *= sc;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float w = expf(mv[i] - Mc);
      L = fmaf(lv[i], w, L);
      O = fmaf(av[i], w, O);
    }
    M = Mc;
  }
  store(out + e, L > 0.f ? O / L : 0.f);
}

template <typename T, int HD, int R>
int launch_hd(const void* q, const void* kpool, const void* vpool,
              const void* table, const void* pos, void* out, void* acc,
              void* ml, int B, int nh, int nkv, int bs, int nb, int n_pool,
              int n_splits, int pps, float scale, cudaStream_t stream) {
  const int rep = nh / nkv;
  const dim3 grid(n_splits, nkv * ((rep + R - 1) / R), B);
  paged_attention_split<T, HD, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<float*>(acc),
      static_cast<float*>(ml), nkv, rep, bs, nb, n_pool, n_splits, pps,
      scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // pass 2 as a programmatic dependent launch: it is scheduled while pass 1
  // runs and waits (griddepcontrol.wait) for pass 1's results, so the gap
  // between the two launches is hidden
  const int rows = B * nh;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows * HD + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_attention_combine<T>,
                                 static_cast<const float*>(acc),
                                 static_cast<const float*>(ml),
                                 static_cast<T*>(out), rows, HD, n_splits);
}

template <typename T, int HD>
int launch_rep(const void* q, const void* kpool, const void* vpool,
               const void* table, const void* pos, void* out, void* acc,
               void* ml, int B, int nh, int nkv, int bs, int nb, int n_pool,
               int n_splits, int pps, float scale, cudaStream_t stream) {
  switch (nh / nkv) {
    case 1:
      return launch_hd<T, HD, 1>(q, kpool, vpool, table, pos, out, acc, ml,
                                 B, nh, nkv, bs, nb, n_pool, n_splits, pps,
                                 scale, stream);
    case 2:
      return launch_hd<T, HD, 2>(q, kpool, vpool, table, pos, out, acc, ml,
                                 B, nh, nkv, bs, nb, n_pool, n_splits, pps,
                                 scale, stream);
    default:
      return launch_hd<T, HD, 4>(q, kpool, vpool, table, pos, out, acc, ml,
                                 B, nh, nkv, bs, nb, n_pool, n_splits, pps,
                                 scale, stream);
  }
}

template <typename T>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* table, const void* pos, void* out, void* acc, void* ml,
           int B, int nh, int nkv, int hd, int bs, int nb, int n_pool,
           int n_splits, int pps, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_rep<T, 16>(q, kpool, vpool, table, pos, out, acc, ml, B,
                               nh, nkv, bs, nb, n_pool, n_splits, pps, scale,
                               s);
    case 32:
      return launch_rep<T, 32>(q, kpool, vpool, table, pos, out, acc, ml, B,
                               nh, nkv, bs, nb, n_pool, n_splits, pps, scale,
                               s);
    case 64:
      return launch_rep<T, 64>(q, kpool, vpool, table, pos, out, acc, ml, B,
                               nh, nkv, bs, nb, n_pool, n_splits, pps, scale,
                               s);
    case 128:
      return launch_rep<T, 128>(q, kpool, vpool, table, pos, out, acc, ml, B,
                                nh, nkv, bs, nb, n_pool, n_splits, pps, scale,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, nh, hd); kpool, vpool (n_pool, bs, nkv, hd); table (B, nb) int32;
// pos (B,) int32; out (B, nh, hd); scratch acc (B, nh, n_splits, hd) f32 and
// ml (B, nh, n_splits, 2) f32. All contiguous, q/kpool/vpool 16-byte
// aligned, hd in {16, 32, 64, 128}, nh % nkv == 0 (checked by ops.py);
// split s covers pages [s * pps, (s + 1) * pps) (ops.split_plan). Launches
// both passes on `stream` and returns a CUDA error code (0 = launched).
extern "C" int paged_attention_f32(const void* q, const void* kpool,
                                   const void* vpool, const void* table,
                                   const void* pos, void* out, void* acc,
                                   void* ml, int B, int nh, int nkv, int hd,
                                   int bs, int nb, int n_pool, int n_splits,
                                   int pps, float scale, void* stream) {
  return launch<float>(q, kpool, vpool, table, pos, out, acc, ml, B, nh, nkv,
                       hd, bs, nb, n_pool, n_splits, pps, scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* kpool,
                                    const void* vpool, const void* table,
                                    const void* pos, void* out, void* acc,
                                    void* ml, int B, int nh, int nkv, int hd,
                                    int bs, int nb, int n_pool, int n_splits,
                                    int pps, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kpool, vpool, table, pos, out, acc, ml, B,
                               nh, nkv, hd, bs, nb, n_pool, n_splits, pps,
                               scale, stream);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
