// Causal flash attention (K3) for Hopper, sm_90a: float32 or bfloat16 in
// and out, float32 accumulation, on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, its pallas_call body `_kernel`).  It computes what
// src/repro/kernels/ref.py::flash_attention computes: for every batch row
// b, head h and query position i, softmax over the keys j with
// i - window < j <= i (window 0: every j <= i) of q_i . k_j * hd^-1/2,
// applied to v.  q, k, v and the output are (B, T, H, hd), GQA already
// expanded.
//
// What bounds it on this card: operations.  At the prefill shape (B 2,
// T 2048, H 16, hd 128) the causal half of q k^T and p v is
// 2 B H T^2 hd = 34.4 GFLOP.  In float32 every product is three TF32
// products (below), so the least time is 3 x 34.4 GFLOP at the H100
// SXM's 495 TFLOP/s of dense TF32 = 0.208 ms (data-sheet rate at its
// 700 W limit), against 134 MB of q, k, v and o (0.040 ms at 3.35 TB/s).
// The same work on the SIMT float32 cores (67 TFLOP/s) takes 0.513 ms.
//
// Float32 on TF32 tensor cores, to float32 accuracy (3xTF32, the helpers
// of csrc/tf32x3.cuh): each operand x is split into big = x rounded to
// TF32 and small = x - big (which the tensor core reads truncated to
// TF32), and a.b is summed as a_small.b_big + a_big.b_small + a_big.b_big
// (the small terms first) with float32 accumulation; what is dropped is
// ~2^-21 of the product.
// bfloat16 inputs take mma m16n8k16 bf16 products (exact in float32) with
// float32 accumulation.
//
// What the design does:
// * One block of 4 warps per (64-row query tile, head, batch row); warp w
//   owns query rows 16 w .. 16 w + 15.  The Pallas grid walked the key
//   blocks as a sequential axis with (m, l, acc) in VMEM scratch; here
//   the key-tile loop lives in the block and (m, l, acc) live in the
//   mma accumulator fragments: lane (g = lane / 4, t = lane % 4) holds
//   rows g and g + 8 of its warp, so a row's max is two shuffles within
//   the quad, and its sum is kept per lane and reduced once at the end.
// * The probabilities never leave registers.  The S accumulator of key
//   columns 8j .. 8j + 7 holds keys 8j + 2t and 8j + 2t + 1 in lane
//   (g, t); p v sums over keys in any order, so the A fragment of p v
//   (columns t and t + 4) takes them as they lie, and the B fragment
//   reads V at the same keys (rows 8j + 2t and 8j + 2t + 1).  No shuffle
//   and no shared memory between the two products.  The head dimension
//   of q k^T is permuted the same way (columns t, t + 4 = d 2t, 2t + 1),
//   so q and k fragments are single 64-bit shared loads.
// * K and V tiles of 64 keys go to shared memory by cp.async 16-byte
//   copies into a two-slot ring: V of tile j loads while q k^T and the
//   softmax of tile j compute, K of tile j + 1 while p v of tile j does.
//   Rows are padded (q, k: 8 floats, v: 4 floats; bf16: 8 values) so that
//   every fragment load is free of bank conflicts.  103 KB a block at
//   hd 128 in float32, so two blocks share an SM.
// * Key tiles wholly above the causal diagonal or wholly before the
//   sliding window are never visited, and the longest query tiles are
//   scheduled first (the grid's last axis runs backwards over them).
// * The online softmax is the Pallas body's: m_new = max(m_prev, rowmax),
//   the correction exp(m_prev - m_new) on l and acc, p = exp(s - m_new)
//   (bf16: rounded to bf16 before p v, as the Pallas body casts p to v's
//   dtype; float32: kept in float32, split as above), and the output
//   acc / max(l, 1e-30).  Exponentials are exp2 of log2(e)-scaled scores.
// * A ragged T is masked here: query rows past T are computed from
//   zero-filled rows and never written; keys past T are zero-filled and
//   masked.
//
// Left for later work: wgmma (TF32 wgmma takes K-major operands only, so
// V would be staged transposed) and TMA loads with a producer warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;   // a masked score, as the reference's
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

// shared-memory row strides, in elements
template <typename T, int HD> struct Pad;
template <int HD> struct Pad<float, HD> {
  static constexpr int kQK = HD + 8;   // 64-bit loads at (row g, col 2t)
  static constexpr int kV = HD + 4;    // 32-bit loads at (row 2t, col g)
};
template <int HD> struct Pad<__nv_bfloat16, HD> {
  static constexpr int kQK = HD + 8;
  static constexpr int kV = HD + 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;      // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of one head into a tile of `stride`-element
// rows; rows at or past seq are zero-filled
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(T* tile, int stride, const T* base,
                                      int row0, int seq,
                                      size_t row_stride) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = HD / kChunk;
  for (int e = threadIdx.x; e < ROWS * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * kChunk;
    const bool valid = row0 + r < seq;
    const T* src = valid ? base + static_cast<size_t>(row0 + r) * row_stride
                               + c
                         : base;
    cp_async16(tile + r * stride + c, src, valid);
  }
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// s[j] = this warp's 16 rows of q against keys 8j .. 8j + 7 of the tile
// (raw dot products).  q_w: the warp's first query row.
template <int HD>
__device__ __forceinline__ void scores(float s[8][4], const float* q_w,
                                       const float* k_s, int g, int t) {
  constexpr int kS = Pad<float, HD>::kQK;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    // fragment column t <-> d = kk + 2t, column t + 4 <-> d = kk + 2t + 1
    const float2 qa = *reinterpret_cast<const float2*>(q_w + g * kS + kk
                                                       + 2 * t);
    const float2 qb = *reinterpret_cast<const float2*>(q_w + (g + 8) * kS
                                                       + kk + 2 * t);
    uint32_t a_big[4], a_small[4];
    split(qa.x, a_big[0], a_small[0]);
    split(qb.x, a_big[1], a_small[1]);
    split(qa.y, a_big[2], a_small[2]);
    split(qb.y, a_big[3], a_small[3]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(
          k_s + (8 * j + g) * kS + kk + 2 * t);
      uint32_t b_big[2], b_small[2];
      split(kv.x, b_big[0], b_small[0]);
      split(kv.y, b_big[1], b_small[1]);
      mma_3xtf32(s[j], a_big, a_small, b_big, b_small);
    }
  }
}

template <int HD>
__device__ __forceinline__ void scores(float s[8][4],
                                       const __nv_bfloat16* q_w,
                                       const __nv_bfloat16* k_s, int g,
                                       int t) {
  constexpr int kS = Pad<__nv_bfloat16, HD>::kQK;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(q_w + g * kS + kk + 2 * t);
    a[1] = ld32(q_w + (g + 8) * kS + kk + 2 * t);
    a[2] = ld32(q_w + g * kS + kk + 2 * t + 8);
    a[3] = ld32(q_w + (g + 8) * kS + kk + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* kr = k_s + (8 * j + g) * kS + kk + 2 * t;
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// o[n] += p . v over the tile's 64 keys; p = s after the softmax
template <int HD>
__device__ __forceinline__ void accumulate(float o[HD / 8][4],
                                           const float s[8][4],
                                           const float* v_s, int g, int t) {
  constexpr int kS = Pad<float, HD>::kV;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // A column t <-> key 8j + 2t, column t + 4 <-> key 8j + 2t + 1
    uint32_t a_big[4], a_small[4];
    split(s[j][0], a_big[0], a_small[0]);
    split(s[j][2], a_big[1], a_small[1]);
    split(s[j][1], a_big[2], a_small[2]);
    split(s[j][3], a_big[3], a_small[3]);
    const float* vr = v_s + (8 * j + 2 * t) * kS + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      uint32_t b_big[2], b_small[2];
      split(vr[8 * n], b_big[0], b_small[0]);
      split(vr[8 * n + kS], b_big[1], b_small[1]);
      mma_3xtf32(o[n], a_big, a_small, b_big, b_small);
    }
  }
}

template <int HD>
__device__ __forceinline__ void accumulate(float o[HD / 8][4],
                                           const float s[8][4],
                                           const __nv_bfloat16* v_s, int g,
                                           int t) {
  constexpr int kS = Pad<__nv_bfloat16, HD>::kV;
#pragma unroll
  for (int j = 0; j < 4; ++j) {      // keys 16j .. 16j + 15
    // p rounded to bf16, as the Pallas body casts p to v's dtype
    const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                           pack_bf16(s[2 * j][2], s[2 * j][3]),
                           pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                           pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
    const __nv_bfloat16* vr = v_s + (16 * j + 2 * t) * kS + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const __nv_bfloat16* c = vr + 8 * n;
      const uint32_t b[2] = {pack_bf16(c[0], c[kS]),
                             pack_bf16(c[8 * kS], c[9 * kS])};
      mma_bf16(o[n], a, b);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool visible(int key, int row, int seq,
                                        int window) {
  return key <= row && key < seq && (window == 0 || key > row - window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq,
                       int H, int window, float scale) {
  constexpr int kQK = Pad<T, HD>::kQK;
  constexpr int kV = Pad<T, HD>::kV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);     // (64, kQK)
  T* k_s = q_s + kBQ * kQK;                    // (64, kQK)
  T* v_s = k_s + kBK * kQK;                    // (64, kV)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + 16 * warp + g;     // this lane's rows: row0, row0 + 8
  const size_t row_stride = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * seq * row_stride +
                          static_cast<size_t>(h) * HD;
  const float scale_log2 = scale * kLog2e;

  const int q_last = min(q0 + kBQ, seq) - 1;
  const int kb_hi = q_last / kBK;                          // causal
  const int kb_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  stage<T, HD, kBQ>(q_s, kQK, q + head_off, q0, seq, row_stride);
  stage<T, HD, kBK>(k_s, kQK, k + head_off, kb_lo * kBK, seq, row_stride);
  cp_async_commit();

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows row0, row0 + 8 (log2 units)
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums

  const int w_first = q0 + 16 * warp;      // the warp's rows
  const int w_last = w_first + 15;
  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBK;
    cp_async_wait_all();
    __syncthreads();   // K(kb) is in; every warp is done with V(kb - 1)
    stage<T, HD, kBK>(v_s, kV, v + head_off, k0, seq, row_stride);
    cp_async_commit();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    scores<HD>(s, q_s + 16 * warp * kQK, k_s, g, t);

    // some key of the tile hidden from some row of the warp
    const bool masked = k0 + kBK - 1 > w_first || k0 + kBK > seq ||
                        (window > 0 && k0 <= w_last - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !masked || visible(key, row0 + 8 * (e >> 1), seq,
                                           window);
        s[j][e] = ok ? s[j][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = !masked || visible(key, row0 + 8 * (e >> 1), seq,
                                           window);
        const float p = ok ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    cp_async_wait_all();
    __syncthreads();   // V(kb) is in; every warp is done with K(kb)
    if (kb < kb_hi) {
      stage<T, HD, kBK>(k_s, kQK, k + head_off, k0 + kBK, seq, row_stride);
      cp_async_commit();
    }
    accumulate<HD>(o, s, v_s, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= seq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* op = out + head_off + static_cast<size_t>(row) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(op + 8 * n, o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int seq, int H, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      ((kBQ + kBK) * Pad<T, HD>::kQK + kBK * Pad<T, HD>::kV) * sizeof(T);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (seq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), seq, H, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int seq, int H, int hd, int window, float scale,
                     cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, seq, H, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, seq, H, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, seq, H, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: (B, seq, H, hd), contiguous, 16-byte aligned, all of one
// dtype (dtype 0: float32, 1: bfloat16).  hd in {32, 64, 128}; window 0
// is plain causal; B <= 65535 and seq <= 64 * 65535.  Launches on
// `stream` of device `device` and returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int seq,
                                   int H, int hd, int window, int dtype,
                                   float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(q, k, v, out, B, seq, H, hd, window, scale, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, out, B, seq, H, hd, window, scale,
                                  s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
