// Causal flash attention (K3) for Hopper, sm_90a: float32 or bfloat16 in
// and out, float32 arithmetic.
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
// 2 B H T^2 hd = 34.4 GFLOP, 0.51 ms at float32's 67 TFLOP/s, against
// 134 MB of q, k, v and o (0.04 ms at 3.35 TB/s).
//
// What the design does about it:
// * One block of 256 threads per (64-row query tile, head, batch row).
//   The Pallas grid walked the key blocks as a sequential axis with
//   (m, l, acc) in VMEM scratch; here the key-block loop lives inside the
//   block and (m, l, acc) live in registers: thread (ty, tx) owns query
//   rows 4 ty .. 4 ty + 3 and head-dim columns tx, tx + 16, ... of the
//   output, and key columns tx, tx + 16, tx + 32, tx + 48 of each score
//   tile, so a row's max and sum are shuffles among the 16 lanes that own
//   it and its correction factor never leaves the thread.
// * Each 64-key K tile is staged in shared memory, then overwritten by the
//   same keys' V tile once the scores are taken (83 KB at hd 128, so two
//   blocks fit an SM); rows are padded by one float so that lanes reading
//   16 different keys hit 16 different banks.
// * The online softmax is the Pallas body's: m_new = max(m_prev, rowmax),
//   the correction exp(m_prev - m_new) on l and acc, p = exp(s - m_new)
//   (cast to v's dtype before p v, as the Pallas body does), and the
//   output acc / max(l, 1e-30).  A masked score contributes p = 0.
// * Key blocks wholly above the causal diagonal or wholly before the
//   sliding window are never visited (the Pallas grid visits and masks
//   them), so the work is the causal half.
// * A ragged T is masked here: query rows past T are computed from zero
//   rows and never written; keys past T are zero-filled and masked.
// * float32 inputs take plain float32 FMAs (no TF32); bfloat16 inputs are
//   widened to float32 as they are staged.
//
// Left for later work: tensor cores (mma.sync / wgmma on bf16, and TF32
// where a caller allows it), cp.async / TMA double-buffering of the K/V
// tiles, and a longer query tile per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p rounded to the value dtype, as the Pallas body casts p before p v
__device__ __forceinline__ float as_value(float p, const float*) { return p; }
__device__ __forceinline__ float as_value(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// rows [row0, row0 + 64) of one head into a (64, HD + 1) float tile; rows
// at or past T are zero
template <typename T, int HD>
__device__ __forceinline__ void stage(float* tile, const T* base, int row0,
                                      int seq, size_t row_stride) {
  constexpr int kVec = HD / 4;
  for (int e = threadIdx.x; e < kBQ * kVec; e += kThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 4;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < seq) load4(base + (row0 + r) * row_stride + c, vals);
    float* dst = tile + r * (HD + 1) + c;
    dst[0] = vals[0]; dst[1] = vals[1]; dst[2] = vals[2]; dst[3] = vals[3];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int seq,
                       int H, int window, float scale) {
  constexpr int kStride = HD + 1;       // padded row of a staged tile
  constexpr int kPStride = kBK + 1;
  constexpr int kCols = HD / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                    // (64, HD + 1)
  float* kv_s = q_s + kBQ * kStride;    // (64, HD + 1): K, then V
  float* p_s = kv_s + kBK * kStride;    // (64, 65) probabilities

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;      // rows 4 ty .. 4 ty + 3
  const int tx = threadIdx.x & 15;
  const size_t row_stride = static_cast<size_t>(H) * HD;
  const size_t head_off = static_cast<size_t>(b) * seq * row_stride +
                          static_cast<size_t>(h) * HD;

  stage<T, HD>(q_s, q + head_off, q0, seq, row_stride);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, seq) - 1;
  const int kb_hi = q_last / kBK;                          // causal
  const int kb_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  for (int kb = kb_lo; kb <= kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // every thread is done with the previous V tile
    stage<T, HD>(kv_s, k + head_off, k0, seq, row_stride);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool valid[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        valid[j] = kj <= qi && kj < seq && (window == 0 || kj > qi - window);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(kFullMask, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        p_s[(ty * 4 + i) * kPStride + tx + 16 * j] = as_value(p, q);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(kFullMask, row_sum, off);
      l[i] = corr * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();   // every thread is done with the K tile
    stage<T, HD>(kv_s, v + head_off, k0, seq, row_stride);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = kv_s[kk * kStride + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* op = out + head_off + qi * row_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(op + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int seq, int H, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      (2 * kBQ * (HD + 1) + kBQ * (kBK + 1)) * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, H, B);
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
// is plain causal.  Launches on `stream` of device `device` and returns
// the launch's cudaError_t.
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
