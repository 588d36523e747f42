// Paged decode attention (K8) for Hopper, sm_90a, float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`paged_attention`, its pallas_call body `_kernel`).  It computes what
// src/repro/kernels/ref.py::paged_attention computes: for every batch row b
// and query head h, softmax attention of the one decode query q[b, h] over
// the first lengths[b] cache positions of row b, where position p lives at
// pool[table[b, p / ps], p % ps, h / group].
//
// What bounds it on this card: bytes.  Each live K/V position is read once
// and used for a handful of FLOPs per byte (2 per element of q.k, 2 per
// element of p.v), far below the H100's ~20 FLOP/byte float32 ridge, so the
// least time is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it:
// * One block per (row b, KV head).  The Pallas grid (B, H, max_pages)
//   carried (m, l, acc) in VMEM across a sequential page axis; blocks on a
//   GPU run in no order, so the page loop lives inside the block.
// * The block serves all H/KV query heads of its KV head (one warp per
//   query head), so each page's K and V are read from device memory once
//   per group, not once per query head.  They are staged in shared memory
//   with 16-byte loads by the whole block.
// * Lane `i` of a warp owns head-dim elements i, i+32, i+64, ...: loads of
//   q, of the staged K/V rows and stores of the output are contiguous
//   across the warp (no shared-memory bank conflicts).
// * The block reads its own table row and length (the TPU kernel's scalar
//   prefetch) and stops after ceil(length / ps) pages: dead pages are never
//   read.  Masked positions contribute exactly 0 to l and acc in the
//   reference, so skipping them is exact.
//
// Precondition (the caller's, as on the serve path where
// lengths = min(pos + 1, max_pages * ps)): 1 <= lengths[b] <= M * ps and
// every table entry a live position reads is a page id in [0, P).  A page
// id outside [0, P) traps instead of reading foreign memory.
//
// Left for later work: splitting the page loop across blocks
// (flash-decoding) for long contexts and small batches, cp.async/TMA
// double-buffering of the page loads, and bf16 pools.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

template <int NPL>  // head-dim elements per lane: hd = 32 * NPL
__global__ void paged_attention_kernel(const float* __restrict__ q,
                                       const float* __restrict__ k_pool,
                                       const float* __restrict__ v_pool,
                                       const int* __restrict__ table,
                                       const int* __restrict__ lengths,
                                       float* __restrict__ out, int H, int KV,
                                       int P, int ps, int M, float scale) {
  constexpr int HD = 32 * NPL;
  constexpr int HD4 = HD / 4;
  extern __shared__ float4 smem4[];
  float4* k_s4 = smem4;              // (ps, HD) staged K page
  float4* v_s4 = smem4 + ps * HD4;   // (ps, HD) staged V page
  const float* k_s = reinterpret_cast<const float*>(k_s4);
  const float* v_s = reinterpret_cast<const float*>(v_s4);

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = H / KV;
  const int lane = threadIdx.x & 31;
  const int h = kvh * group + (threadIdx.x >> 5);  // this warp's query head

  float qr[NPL], acc[NPL];
  const float* qp = q + (static_cast<size_t>(b) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    qr[i] = qp[lane + 32 * i];
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int len = min(lengths[b], M * ps);
  const int n_pages = (len + ps - 1) / ps;
  const size_t row_stride4 = static_cast<size_t>(KV) * HD4;  // position step
  const int page_elems4 = ps * HD4;

  for (int j = 0; j < n_pages; ++j) {
    const int page = table[b * M + j];
    if (page < 0 || page >= P) __trap();
    const size_t base4 =
        (static_cast<size_t>(page) * ps * KV + kvh) * HD4;
    const float4* kp = reinterpret_cast<const float4*>(k_pool) + base4;
    const float4* vp = reinterpret_cast<const float4*>(v_pool) + base4;
    __syncthreads();  // every warp is done with the previous page
    for (int e = threadIdx.x; e < page_elems4; e += blockDim.x) {
      const int t = e / HD4;
      const int c = e - t * HD4;
      k_s4[e] = kp[t * row_stride4 + c];
      v_s4[e] = vp[t * row_stride4 + c];
    }
    __syncthreads();

    const int live = min(ps, len - j * ps);
    for (int t = 0; t < live; ++t) {
      const float* kr = k_s + t * HD;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) s += qr[i] * kr[lane + 32 * i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(kFullMask, s, off);
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
      const float* vr = v_s + t * HD;
#pragma unroll
      for (int i = 0; i < NPL; ++i) acc[i] = acc[i] * corr + p * vr[lane + 32 * i];
      m = m_new;
    }
  }

  const float denom = fmaxf(l, 1e-30f);
  float* op = out + (static_cast<size_t>(b) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < NPL; ++i) op[lane + 32 * i] = acc[i] / denom;
}

template <int NPL>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* table, const int* lengths, float* out, int B,
                   int H, int KV, int P, int ps, int M, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(ps) * 32 * NPL * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<NPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KV);
  const dim3 block(32 * (H / KV));
  paged_attention_kernel<NPL><<<grid, block, smem, stream>>>(
      q, k_pool, v_pool, table, lengths, out, H, KV, P, ps, M, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd), k_pool/v_pool (P, ps, KV, hd), out (B, H, hd): float32,
// contiguous, 16-byte aligned.  table (B, M), lengths (B,): int32.
// hd in {32, 64, 128, 256}; H % KV == 0 and H / KV <= 32.  Launches on
// `stream` of device `device` and returns the launch's cudaError_t.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool, const int* table,
                                   const int* lengths, float* out, int B,
                                   int H, int KV, int hd, int P, int ps,
                                   int M, float scale, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      err = launch<1>(q, k_pool, v_pool, table, lengths, out, B, H, KV, P,
                      ps, M, scale, s);
      break;
    case 64:
      err = launch<2>(q, k_pool, v_pool, table, lengths, out, B, H, KV, P,
                      ps, M, scale, s);
      break;
    case 128:
      err = launch<4>(q, k_pool, v_pool, table, lengths, out, B, H, KV, P,
                      ps, M, scale, s);
      break;
    case 256:
      err = launch<8>(q, k_pool, v_pool, table, lengths, out, B, H, KV, P,
                      ps, M, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
