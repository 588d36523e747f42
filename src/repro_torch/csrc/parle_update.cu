// Parle's update kernels for Hopper, sm_90a: the inner step (K1), the sync
// step (K2), the Elastic-SGD worker step (K7) and the compressed sync (K4,
// K5, K6).
//
// They replace the Pallas TPU kernels of src/repro/kernels/parle_update.py:
// K1 `parle_update_flat` (pallas_call body `_kernel`), K2 `parle_sync_flat`
// (`_sync_kernel`), K7 `elastic_update_flat` (`_elastic_kernel`), K4
// `quantize_ef_flat` (`_quant_ef_kernel`), K5
// `parle_sync_dequant_flat` (`_dequant_sync_kernel`) and K6
// `parle_apply_quantize_flat` (`_apply_quant_kernel`).  They compute what
// src/repro/kernels/ref.py's oracles compute:
//
//   K1 (Eq. 8a-8b), elementwise over every replica and leaf:
//     g_y = g + inv_gamma (y - x);  v' = mu v + g_y
//     y'  = y - lr (g_y + mu v');   z' = alpha z + (1 - alpha) y'
//   K2 (Eq. 8c-8d), per replica row r against ONE shared row xbar:
//     g_x = gamma_scale (x - z) + inv_rho (x - xbar);  v' = mu v + g_x
//     x'  = x - lr (g_x + mu v');  optionally y' = bf16(x')
//   K7 (Eq. 7a), per replica row r against ONE shared row ref:
//     g_e = g + inv_rho (x - ref);  v' = mu v + g_e;  x' = x - lr (g_e + mu v')
//   K4 (the int8 codec with error feedback), per 1024-element chunk of c:
//     s = amax == 0 ? 1 : amax * f32(1/127)   (amax = max |c|, NaN kept)
//     q = clip(rint(c / s), -127, 127) as int8;  e = c - q s
//   K5: xbar = (sum over the n payloads a, left to right, of q_a s_a) / n,
//     then K2 against it (+ y').  xbar never goes to device memory.
//   K6: K2 against the carried consensus c (+ y'), then K4 on x' + e: the
//     next payload q, s and its residual e', in one pass.
//
// What bounds them on this card: bytes.  Each element costs 15 (K1) or 11
// (K2) float operations against 32 (K1, f32) or 28+ (K2) bytes of traffic,
// far below the H100's ~20 FLOP/byte float32 ridge.  K1 reads y, z, v, g, x
// and writes y, z, v: 8 streams.  K2 reads x, z, v (R rows) and xbar (one
// row) and writes x, v (and y'): 3R + 1 reads, 2R (+R) writes.  K7 has K2's
// streams with g in place of z (9 operations an element).  K4 reads c
// and writes e (f32) and q (int8): 9 bytes an element.  K5 reads x, z, v and
// the n int8 payloads once, writes x, v.  K6 reads x, z, v, e and c once,
// writes x, v, e and q.  Each does ~10-20 operations an element.  The least
// time is those bytes over 3.35 TB/s.
//
// What the design does about it:
// * One launch covers the whole state.  The caller keeps each state field
//   as one contiguous (R, M) buffer in which every parameter leaf starts
//   at a multiple of 8192 elements, with zeros in the gaps (the zeros stay
//   zero under both updates), so there is no per-leaf launch and no
//   padding copy.
// * A grid-stride loop with 16-byte vector accesses (four f32, or four bf16
//   as two bf16x2) where every stream is aligned, and a scalar tail for
//   ragged lengths; enough blocks to fill the 132 SMs several times over.
// * K2 and K7 run one grid row per replica (blockIdx.y), so each thread
//   reads xbar[j] (ref[j]) for its own column j: the shared row stays one
//   (M,) buffer, never broadcast to R x M.
// * The four scalars are read from device memory (the counterpart of the
//   TPU kernels' scalar prefetch), so a captured CUDA graph can replay a
//   round with new scalars and no change to this interface.
// * The updates are in place: each thread reads an element of y, z, v
//   (K1) or x, v (K2, K7) before it writes the same element, and no two
//   threads touch one element.
// * Exact rounding: every product and sum is __fmul_rn / __fadd_rn /
//   __fsub_rn, so nvcc cannot contract a*b+c into an FMA, and casts to
//   bf16 are __float2bfloat16_rn (round to nearest even).  Each kernel
//   therefore equals its plain PyTorch version (one rounding per torch op,
//   in the same order) bit for bit.
// * The int8 kernels (K4-K6) give one 256-thread block one 1024-element
//   chunk at a time, four elements (one float4) a thread, in a grid-stride
//   loop over the R x M/1024 chunks: M is a multiple of 8192 (the flat
//   layout's leaf alignment), so chunks never straddle a row or a leaf.
//   The chunk's amax is a shuffle reduction within each warp, then 8 warp
//   values in shared memory.  Rounding is the reference's: a correctly
//   rounded division (__fdiv_rn), half-to-even rintf (not roundf), and a
//   max that keeps a NaN as torch.amax does (fmaxf would drop it).  The
//   residual is c - float(int8 code) * s, as the plain version forms it.
// * K4 may run in place (c and e one buffer): each thread reads its four
//   elements before the block's reduction and writes them after it.  K5
//   reads the n payloads' codes for its own four columns and their chunk's
//   scale; the (M,) mean is never written.  K6 reads c (M,) once per
//   replica row, as K2 reads xbar.
// * Indices are int64: the training state is 1.86e9 elements at n = 2.
//
// Left for later work: CUDA-graph capture of a round, and fusing the
// sync's inner-loop reset (z <- x', y <- x', v_y <- 0) into K2, K5, K6.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements of T as one aligned access.
template <typename T>
struct Pack4;

template <>
struct Pack4<float> {
  __device__ static void load(const float* p, float f[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static void store(float* p, const float f[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack4<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float f[4]) {
    const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
    const __nv_bfloat162 a = q[0];
    const __nv_bfloat162 b = q[1];
    f[0] = __low2float(a);
    f[1] = __high2float(a);
    f[2] = __low2float(b);
    f[3] = __high2float(b);
  }
  __device__ static void store(__nv_bfloat16* p, const float f[4]) {
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
    q[0] = __halves2bfloat162(__float2bfloat16_rn(f[0]),
                              __float2bfloat16_rn(f[1]));
    q[1] = __halves2bfloat162(__float2bfloat16_rn(f[2]),
                              __float2bfloat16_rn(f[3]));
  }
};

struct InnerScalars {
  float inv_gamma, lr, mu, alpha, one_minus_alpha;
};

struct SyncScalars {
  float gamma_scale, inv_rho, lr, mu;
};

struct ElasticScalars {
  float inv_rho, lr, mu;
};

// Eq. 8a-8b for one element, in the plain version's order of roundings.
__device__ __forceinline__ void inner_elem(const InnerScalars& s, float y,
                                           float g, float x, float& z,
                                           float& v, float& y_new) {
  const float g_y = __fadd_rn(g, __fmul_rn(s.inv_gamma, __fsub_rn(y, x)));
  const float v_new = __fadd_rn(__fmul_rn(s.mu, v), g_y);
  y_new = __fsub_rn(
      y, __fmul_rn(s.lr, __fadd_rn(g_y, __fmul_rn(s.mu, v_new))));
  z = __fadd_rn(__fmul_rn(s.alpha, z), __fmul_rn(s.one_minus_alpha, y_new));
  v = v_new;
}

// Eq. 8c-8d for one element.
__device__ __forceinline__ void sync_elem(const SyncScalars& s, float& x,
                                          float z, float& v, float xbar) {
  const float g_x = __fadd_rn(__fmul_rn(s.gamma_scale, __fsub_rn(x, z)),
                              __fmul_rn(s.inv_rho, __fsub_rn(x, xbar)));
  const float v_new = __fadd_rn(__fmul_rn(s.mu, v), g_x);
  x = __fsub_rn(x, __fmul_rn(s.lr, __fadd_rn(g_x, __fmul_rn(s.mu, v_new))));
  v = v_new;
}

// Eq. 7a for one element.
__device__ __forceinline__ void elastic_elem(const ElasticScalars& s, float& x,
                                             float& v, float g, float ref) {
  const float g_e = __fadd_rn(g, __fmul_rn(s.inv_rho, __fsub_rn(x, ref)));
  const float v_new = __fadd_rn(__fmul_rn(s.mu, v), g_e);
  x = __fsub_rn(x, __fmul_rn(s.lr, __fadd_rn(g_e, __fmul_rn(s.mu, v_new))));
  v = v_new;
}

// y and g: T (float or bf16); z, v, x: float.  n elements in all, the first
// 4 * n_vec of them through aligned 4-element accesses.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    parle_inner_kernel(T* __restrict__ y, float* __restrict__ z,
                       float* __restrict__ v, const T* __restrict__ g,
                       const float* __restrict__ x,
                       const float* __restrict__ scalars, int64_t n,
                       int64_t n_vec) {
  InnerScalars s;
  s.inv_gamma = scalars[0];
  s.lr = scalars[1];
  s.mu = scalars[2];
  s.alpha = scalars[3];
  s.one_minus_alpha = __fsub_rn(1.0f, s.alpha);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) {
    const int64_t e = 4 * i;
    float yf[4], gf[4], xf[4], zf[4], vf[4], yo[4];
    Pack4<T>::load(y + e, yf);
    Pack4<T>::load(g + e, gf);
    Pack4<float>::load(x + e, xf);
    Pack4<float>::load(z + e, zf);
    Pack4<float>::load(v + e, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      inner_elem(s, yf[k], gf[k], xf[k], zf[k], vf[k], yo[k]);
    Pack4<T>::store(y + e, yo);
    Pack4<float>::store(z + e, zf);
    Pack4<float>::store(v + e, vf);
  }
  for (int64_t e = 4 * n_vec + tid; e < n; e += stride) {
    float zf = z[e], vf = v[e], yo;
    inner_elem(s, to_f32(y[e]), to_f32(g[e]), x[e], zf, vf, yo);
    y[e] = from_f32<T>(yo);
    z[e] = zf;
    v[e] = vf;
  }
}

// x, z, v: (R, M) float, row r = blockIdx.y; xbar: (M,) float; y_out:
// (R, M) bf16 when EMIT_Y.  The first 4 * m_vec columns of each row go
// through aligned 4-element accesses.
template <bool EMIT_Y>
__global__ void __launch_bounds__(kThreads)
    parle_sync_kernel(float* __restrict__ x, const float* __restrict__ z,
                      float* __restrict__ v, const float* __restrict__ xbar,
                      __nv_bfloat16* __restrict__ y_out,
                      const float* __restrict__ scalars, int64_t M,
                      int64_t m_vec) {
  SyncScalars s;
  s.gamma_scale = scalars[0];
  s.inv_rho = scalars[1];
  s.lr = scalars[2];
  s.mu = scalars[3];
  const int64_t row = static_cast<int64_t>(blockIdx.y) * M;
  float* xr = x + row;
  const float* zr = z + row;
  float* vr = v + row;
  __nv_bfloat16* yr = EMIT_Y ? y_out + row : nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t i = tid; i < m_vec; i += stride) {
    const int64_t j = 4 * i;
    float xf[4], zf[4], vf[4], bf[4];
    Pack4<float>::load(xr + j, xf);
    Pack4<float>::load(zr + j, zf);
    Pack4<float>::load(vr + j, vf);
    Pack4<float>::load(xbar + j, bf);
#pragma unroll
    for (int k = 0; k < 4; ++k) sync_elem(s, xf[k], zf[k], vf[k], bf[k]);
    Pack4<float>::store(xr + j, xf);
    Pack4<float>::store(vr + j, vf);
    if (EMIT_Y) Pack4<__nv_bfloat16>::store(yr + j, xf);
  }
  for (int64_t j = 4 * m_vec + tid; j < M; j += stride) {
    float xf = xr[j], vf = vr[j];
    sync_elem(s, xf, zr[j], vf, xbar[j]);
    xr[j] = xf;
    vr[j] = vf;
    if (EMIT_Y) yr[j] = __float2bfloat16_rn(xf);
  }
}

// K7.  x, v: (R, M) float, row r = blockIdx.y; g: (R, M) GT (float or bf16);
// ref: (M,) float.  The first 4 * m_vec columns of each row go through
// aligned 4-element accesses.
template <typename GT>
__global__ void __launch_bounds__(kThreads)
    elastic_kernel(float* __restrict__ x, float* __restrict__ v,
                   const GT* __restrict__ g, const float* __restrict__ ref,
                   const float* __restrict__ scalars, int64_t M,
                   int64_t m_vec) {
  ElasticScalars s;
  s.inv_rho = scalars[0];
  s.lr = scalars[1];
  s.mu = scalars[2];
  const int64_t row = static_cast<int64_t>(blockIdx.y) * M;
  float* xr = x + row;
  float* vr = v + row;
  const GT* gr = g + row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (int64_t i = tid; i < m_vec; i += stride) {
    const int64_t j = 4 * i;
    float xf[4], vf[4], gf[4], rf[4];
    Pack4<float>::load(xr + j, xf);
    Pack4<float>::load(vr + j, vf);
    Pack4<GT>::load(gr + j, gf);
    Pack4<float>::load(ref + j, rf);
#pragma unroll
    for (int k = 0; k < 4; ++k) elastic_elem(s, xf[k], vf[k], gf[k], rf[k]);
    Pack4<float>::store(xr + j, xf);
    Pack4<float>::store(vr + j, vf);
  }
  for (int64_t j = 4 * m_vec + tid; j < M; j += stride) {
    float xf = xr[j], vf = vr[j];
    elastic_elem(s, xf, vf, to_f32(gr[j]), ref[j]);
    xr[j] = xf;
    vr[j] = vf;
  }
}

// ---------------------------------------------------------------------------
// The compressed sync: K4, K5, K6.  One block per 1024-element chunk at a
// time, four elements a thread.
// ---------------------------------------------------------------------------

constexpr int kChunk = 1024;                  // elements per int8 scale
static_assert(kChunk == 4 * kThreads, "one float4 per thread per chunk");
constexpr float kInv127 = 0x1.020408p-7f;     // f32(1/127)

// max that keeps a NaN (either operand), as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// max |f| over the block's chunk (4 values a thread); every thread gets it.
__device__ __forceinline__ float chunk_amax(const float f[4],
                                            float* warp_max) {
  float m = nan_max(nan_max(fabsf(f[0]), fabsf(f[1])),
                    nan_max(fabsf(f[2]), fabsf(f[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
  __syncthreads();  // the next chunk rewrites warp_max
  return m;
}

__device__ __forceinline__ float chunk_scale(float amax) {
  return amax == 0.0f ? 1.0f : __fmul_rn(amax, kInv127);
}

// int8 codes of four values under scale s, and their residuals c - q s.
__device__ __forceinline__ char4 quantize4(const float c[4], float s,
                                           float e[4]) {
  signed char q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(c[k], s)), -127.0f), 127.0f);
    q[k] = static_cast<signed char>(r);
    e[k] = __fsub_rn(c[k], __fmul_rn(static_cast<float>(q[k]), s));
  }
  return make_char4(q[0], q[1], q[2], q[3]);
}

// K4.  c, e: n_chunks x 1024 float (may be one buffer); q: as many int8;
// s: n_chunks float.
__global__ void __launch_bounds__(kThreads)
    quantize_ef_kernel(const float* c, int8_t* __restrict__ q,
                       float* __restrict__ s, float* e, int64_t n_chunks) {
  __shared__ float warp_max[kThreads / 32];
  for (int64_t k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    const int64_t i = k * kChunk + 4 * threadIdx.x;
    float cf[4], ef[4];
    Pack4<float>::load(c + i, cf);
    const float sc = chunk_scale(chunk_amax(cf, warp_max));
    *reinterpret_cast<char4*>(q + i) = quantize4(cf, sc, ef);
    Pack4<float>::store(e + i, ef);
    if (threadIdx.x == 0) s[k] = sc;
  }
}

// K5.  x, z, v: (R, M) float; q: (n, M) int8; s: (n, M/1024) float; y_out:
// (R, M) bf16 when EMIT_Y.  Chunk k covers row k / (M/1024).
template <bool EMIT_Y>
__global__ void __launch_bounds__(kThreads)
    parle_sync_dequant_kernel(float* __restrict__ x,
                              const float* __restrict__ z,
                              float* __restrict__ v,
                              const int8_t* __restrict__ q,
                              const float* __restrict__ s,
                              __nv_bfloat16* __restrict__ y_out,
                              const float* __restrict__ scalars, int n,
                              int64_t M, int64_t n_chunks) {
  SyncScalars sc;
  sc.gamma_scale = scalars[0];
  sc.inv_rho = scalars[1];
  sc.lr = scalars[2];
  sc.mu = scalars[3];
  const int64_t chunks_per_row = M / kChunk;
  const float nf = static_cast<float>(n);
  for (int64_t k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    const int64_t col_chunk = k % chunks_per_row;
    const int64_t j = col_chunk * kChunk + 4 * threadIdx.x;  // column
    const int64_t i = (k / chunks_per_row) * M + j;           // element
    float xbar[4];
    for (int a = 0; a < n; ++a) {
      const char4 qa =
          *reinterpret_cast<const char4*>(q + static_cast<int64_t>(a) * M + j);
      const float sa = s[static_cast<int64_t>(a) * chunks_per_row + col_chunk];
      const float d[4] = {__fmul_rn(static_cast<float>(qa.x), sa),
                          __fmul_rn(static_cast<float>(qa.y), sa),
                          __fmul_rn(static_cast<float>(qa.z), sa),
                          __fmul_rn(static_cast<float>(qa.w), sa)};
#pragma unroll
      for (int t = 0; t < 4; ++t) xbar[t] = a == 0 ? d[t] : __fadd_rn(xbar[t], d[t]);
    }
    float xf[4], zf[4], vf[4];
    Pack4<float>::load(x + i, xf);
    Pack4<float>::load(z + i, zf);
    Pack4<float>::load(v + i, vf);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      sync_elem(sc, xf[t], zf[t], vf[t], __fdiv_rn(xbar[t], nf));
    Pack4<float>::store(x + i, xf);
    Pack4<float>::store(v + i, vf);
    if (EMIT_Y) Pack4<__nv_bfloat16>::store(y_out + i, xf);
  }
}

// K6.  x, z, v, e: (R, M) float; c: (M,) float; q: (R, M) int8; s: (R,
// M/1024) float; y_out: (R, M) bf16 when EMIT_Y.
template <bool EMIT_Y>
__global__ void __launch_bounds__(kThreads)
    parle_apply_quantize_kernel(float* __restrict__ x,
                                const float* __restrict__ z,
                                float* __restrict__ v,
                                const float* __restrict__ c,
                                float* __restrict__ e,
                                int8_t* __restrict__ q,
                                float* __restrict__ s,
                                __nv_bfloat16* __restrict__ y_out,
                                const float* __restrict__ scalars, int64_t M,
                                int64_t n_chunks) {
  __shared__ float warp_max[kThreads / 32];
  SyncScalars sc;
  sc.gamma_scale = scalars[0];
  sc.inv_rho = scalars[1];
  sc.lr = scalars[2];
  sc.mu = scalars[3];
  const int64_t chunks_per_row = M / kChunk;
  for (int64_t k = blockIdx.x; k < n_chunks; k += gridDim.x) {
    const int64_t j = (k % chunks_per_row) * kChunk + 4 * threadIdx.x;
    const int64_t i = (k / chunks_per_row) * M + j;
    float xf[4], zf[4], vf[4], cf[4], ef[4], tot[4];
    Pack4<float>::load(x + i, xf);
    Pack4<float>::load(z + i, zf);
    Pack4<float>::load(v + i, vf);
    Pack4<float>::load(c + j, cf);
    Pack4<float>::load(e + i, ef);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      sync_elem(sc, xf[t], zf[t], vf[t], cf[t]);
      tot[t] = __fadd_rn(xf[t], ef[t]);  // the next payload, error fed back
    }
    const float scale = chunk_scale(chunk_amax(tot, warp_max));
    *reinterpret_cast<char4*>(q + i) = quantize4(tot, scale, ef);
    Pack4<float>::store(x + i, xf);
    Pack4<float>::store(v + i, vf);
    Pack4<float>::store(e + i, ef);
    if (EMIT_Y) Pack4<__nv_bfloat16>::store(y_out + i, xf);
    if (threadIdx.x == 0) s[k] = scale;
  }
}

// Blocks for `work` threads' worth of elements, capped at kBlocksPerSM
// resident blocks on every SM (the grid-stride loop covers the rest).
cudaError_t grid_size(int device, int64_t work, int rows, int* blocks) {
  int sms = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSM;
  const int64_t per_row = (cap + rows - 1) / rows;
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > per_row) b = per_row;
  if (b < 1) b = 1;
  *blocks = static_cast<int>(b);
  return cudaSuccess;
}

}  // namespace

// K1.  y and g: bf16 when `bf16` != 0, else float; z, v, x: float; all n
// elements, contiguous.  scalars: 4 floats on the device [inv_gamma, lr, mu,
// alpha].  `vec` != 0 promises that every pointer is 16-byte aligned (8-byte
// for bf16 streams).  Updates y, z, v in place on `stream` of `device` and
// returns the launch's cudaError_t.
extern "C" int parle_inner_update(void* y, float* z, float* v, const void* g,
                                  const float* x, const float* scalars,
                                  int64_t n, int bf16, int vec, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_vec = vec ? n / 4 : 0;
  int blocks = 0;
  err = grid_size(device, n_vec + (n - 4 * n_vec), 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    parle_inner_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(y), z, v,
        static_cast<const __nv_bfloat16*>(g), x, scalars, n, n_vec);
  } else {
    parle_inner_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<float*>(y), z, v, static_cast<const float*>(g), x,
        scalars, n, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2.  x, z, v: (R, M) float; xbar: (M,) float; y_out: (R, M) bf16 or null;
// scalars: 4 floats on the device [gamma_scale, inv_rho, lr, mu].  `vec` != 0
// promises 16-byte aligned pointers (8-byte for y_out) and M % 4 == 0.
// Updates x, v in place and writes y_out = bf16(x') when it is not null.
extern "C" int parle_sync_update(float* x, const float* z, float* v,
                                 const float* xbar, void* y_out,
                                 const float* scalars, int R, int64_t M,
                                 int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R < 1 || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t m_vec = vec ? M / 4 : 0;
  int blocks = 0;
  err = grid_size(device, m_vec + (M - 4 * m_vec), R, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_out != nullptr) {
    parle_sync_kernel<true><<<grid, kThreads, 0, s>>>(
        x, z, v, xbar, static_cast<__nv_bfloat16*>(y_out), scalars, M,
        m_vec);
  } else {
    parle_sync_kernel<false><<<grid, kThreads, 0, s>>>(
        x, z, v, xbar, nullptr, scalars, M, m_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  x, v: (R, M) float; g: (R, M) bf16 when `bf16` != 0, else float;
// ref: (M,) float; scalars: 3 floats on the device [inv_rho, lr, mu].  `vec`
// != 0 promises 16-byte aligned pointers (8-byte for a bf16 g) and M % 4 ==
// 0.  Updates x, v in place; ref is only read.
extern "C" int elastic_update(float* x, float* v, const void* g,
                              const float* ref, const float* scalars, int R,
                              int64_t M, int bf16, int vec, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R < 1 || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t m_vec = vec ? M / 4 : 0;
  int blocks = 0;
  err = grid_size(device, m_vec + (M - 4 * m_vec), R, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, R);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    elastic_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        x, v, static_cast<const __nv_bfloat16*>(g), ref, scalars, M, m_vec);
  } else {
    elastic_kernel<float><<<grid, kThreads, 0, s>>>(
        x, v, static_cast<const float*>(g), ref, scalars, M, m_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.  c, e: n_chunks x 1024 float, contiguous, 16-byte aligned, and may be
// one buffer; q: as many int8, 4-byte aligned; s: n_chunks float.  Writes
// q, s and e = c - q s.
extern "C" int quantize_ef(const float* c, void* q, float* s, float* e,
                           int64_t n_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = grid_size(device, n_chunks * kThreads, 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_ef_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(
                                                 stream)>>>(
      c, static_cast<int8_t*>(q), s, e, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// K5.  x, z, v: (R, M) float with M % 1024 == 0; q: (n, M) int8; s: (n,
// M/1024) float; y_out: (R, M) bf16 or null; scalars: 4 floats on the
// device [gamma_scale, inv_rho, lr, mu].  Streams 16-byte aligned (q
// 4-byte, y_out 8-byte).  Updates x, v in place against the mean of the n
// dequantized payloads; writes y_out = bf16(x') when it is not null.
extern "C" int parle_sync_dequant(float* x, const float* z, float* v,
                                  const void* q, const float* s, void* y_out,
                                  const float* scalars, int R, int n,
                                  int64_t M, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R < 1 || n < 1 || M % kChunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = static_cast<int64_t>(R) * (M / kChunk);
  int blocks = 0;
  err = grid_size(device, n_chunks * kThreads, 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* q8 = static_cast<const int8_t*>(q);
  if (y_out != nullptr) {
    parle_sync_dequant_kernel<true><<<blocks, kThreads, 0, st>>>(
        x, z, v, q8, s, static_cast<__nv_bfloat16*>(y_out), scalars, n, M,
        n_chunks);
  } else {
    parle_sync_dequant_kernel<false><<<blocks, kThreads, 0, st>>>(
        x, z, v, q8, s, nullptr, scalars, n, M, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6.  x, z, v, e: (R, M) float with M % 1024 == 0; c: (M,) float; q: (R, M)
// int8; s: (R, M/1024) float; y_out: (R, M) bf16 or null; scalars as K5.
// Alignment as K5.  Updates x, v, e in place and writes q, s (and y_out).
extern "C" int parle_apply_quantize(float* x, const float* z, float* v,
                                    const float* c, float* e, void* q,
                                    float* s, void* y_out,
                                    const float* scalars, int R, int64_t M,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R < 1 || M % kChunk != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_chunks = static_cast<int64_t>(R) * (M / kChunk);
  int blocks = 0;
  err = grid_size(device, n_chunks * kThreads, 1, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q8 = static_cast<int8_t*>(q);
  if (y_out != nullptr) {
    parle_apply_quantize_kernel<true><<<blocks, kThreads, 0, st>>>(
        x, z, v, c, e, q8, s, static_cast<__nv_bfloat16*>(y_out), scalars, M,
        n_chunks);
  } else {
    parle_apply_quantize_kernel<false><<<blocks, kThreads, 0, st>>>(
        x, z, v, c, e, q8, s, nullptr, scalars, M, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
