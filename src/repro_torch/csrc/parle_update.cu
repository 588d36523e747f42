// Parle's inner step (K1) and sync step (K2) for Hopper, sm_90a.
//
// K1 replaces the Pallas TPU kernel src/repro/kernels/parle_update.py
// `parle_update_flat` (pallas_call body `_kernel`); K2 replaces
// `parle_sync_flat` (body `_sync_kernel`).  They compute what
// src/repro/kernels/ref.py::parle_inner_update / parle_sync_update compute:
//
//   K1 (Eq. 8a-8b), elementwise over every replica and leaf:
//     g_y = g + inv_gamma (y - x);  v' = mu v + g_y
//     y'  = y - lr (g_y + mu v');   z' = alpha z + (1 - alpha) y'
//   K2 (Eq. 8c-8d), per replica row r against ONE shared row xbar:
//     g_x = gamma_scale (x - z) + inv_rho (x - xbar);  v' = mu v + g_x
//     x'  = x - lr (g_x + mu v');  optionally y' = bf16(x')
//
// What bounds them on this card: bytes.  Each element costs 15 (K1) or 11
// (K2) float operations against 32 (K1, f32) or 28+ (K2) bytes of traffic,
// far below the H100's ~20 FLOP/byte float32 ridge.  K1 reads y, z, v, g, x
// and writes y, z, v: 8 streams.  K2 reads x, z, v (R rows) and xbar (one
// row) and writes x, v (and y'): 3R + 1 reads, 2R (+R) writes.  The least
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
// * K2 runs one grid row per replica (blockIdx.y), so each thread reads
//   xbar[j] for its own column j: xbar stays one (M,) buffer, never
//   broadcast to R x M.
// * The four scalars are read from device memory (the counterpart of the
//   TPU kernels' scalar prefetch), so a captured CUDA graph can replay a
//   round with new scalars and no change to this interface.
// * The updates are in place: each thread reads an element of y, z, v
//   (K1) or x, v (K2) before it writes the same element, and no two
//   threads touch one element.
// * Exact rounding: every product and sum is __fmul_rn / __fadd_rn /
//   __fsub_rn, so nvcc cannot contract a*b+c into an FMA, and casts to
//   bf16 are __float2bfloat16_rn (round to nearest even).  Each kernel
//   therefore equals its plain PyTorch version (one rounding per torch op,
//   in the same order) bit for bit.
//
// Left for later work: CUDA-graph capture of a round, and fusing the
// sync's inner-loop reset (z <- x', y <- x', v_y <- 0) into K2.
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
