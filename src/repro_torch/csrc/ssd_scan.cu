// Chunked SSD (Mamba2) selective scan (K9) for Hopper, sm_90a: float32 or
// bfloat16 in and out, float32 arithmetic throughout.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (`ssd_scan`, its pallas_call body `_kernel`, and the jnp epilogue that
// recomputes the final state).  Per batch row b and head h, from a zero
// state, over chunks of Q tokens with cum the inclusive cumsum of dt A
// within the chunk, it computes what the Pallas body computes:
//   intra-chunk  y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter-chunk  y_i += exp(cum_i) C_i . h_prev
//   state        h    = exp(cum_last) h_prev
//                       + sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j
// and writes h after the last chunk as the final state.  That equals
// src/repro/kernels/ref.py::ssd_scan, the naive recurrence
// h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t, y_t = C_t . h_t.
//
// What bounds it on this card: operations.  Per (b, head, chunk) the full
// (Q x Q) products would be 2 Q^2 N + 2 Q^2 P + 4 Q N P FLOP; the scan
// needs only their causal half, Q (Q + 1) N + Q (Q + 1) P + 4 Q N P.  At
// Mamba2-1.3B's prefill shape (B 2, T 2048, nh 64, P 64, N 128, Q 128)
// that is 15.1 GFLOP, 0.225 ms at float32's 67 TFLOP/s, against 0.14 GB
// of x, dt, B, C, y and the final state (0.04 ms at 3.35 TB/s).
//
// What the design does about it:
// * One block of 256 threads per (head, batch row).  Its sequential chunk
//   loop replaces the Pallas "arbitrary" grid axis, and the carried state
//   h (N x P float32: 32 KB at N 128, P 64) stays in shared memory across
//   chunks, as it stayed in VMEM.  B x nh = 128 blocks at B 2 is about
//   one wave on the 132 SMs.
// * Each chunk stages x (Q x P) and B (Q x N) once; C and the decayed
//   scores go through in tiles of 32 query rows, each warp owning 4 rows,
//   so the (Q x Q) score matrix never exists whole and a warp reads back
//   only the scores it wrote.  166 KB of shared memory at Mamba2's shape.
// * exp(cum_i - cum_j) is taken only for j <= i, and only the score
//   columns a tile's rows can see (j < its last row + 1) are computed.
// * The state update scales B by w_j = exp(cum_last - cum_j) dt_j in
//   place, then each thread updates its own 16 x 2 entries of h.
// * Rows of B and C are padded by one float, so lanes reading 32
//   different rows of one column hit 32 different banks.
//
// Left for later work: tensor cores (TF32 / bf16 mma) for the four
// products, more blocks per head (chunk-parallel states, then a pass over
// the chunk states) to fill the card at small batch, and cp.async
// staging of the next chunk.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;          // query rows per score tile
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 128;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                T* __restrict__ h_final, int seq, int nh, int N, int Q,
                long long x_sb, long long x_st, long long dt_sb,
                long long dt_st, long long b_sb, long long b_st,
                long long c_sb, long long c_st) {
  constexpr int kPC = P / 32;            // state / output columns per lane
  constexpr int kMaxK = kMaxState / kWarps;
  extern __shared__ float smem[];
  const int NS = N + 1;                  // padded row of B and C
  const int SS = Q + 1;                  // padded row of the score tile
  float* h_s = smem;                     // (N, P) carried state
  float* x_s = h_s + N * P;              // (Q, P)
  float* b_s = x_s + Q * P;              // (Q, N + 1)
  float* c_s = b_s + Q * NS;             // (32, N + 1)
  float* s_s = c_s + kTileRows * NS;     // (32, Q + 1) decayed scores
  float* cum_s = s_s + kTileRows * SS;   // (Q)
  float* dt_s = cum_s + Q;               // (Q)
  float* w_s = dt_s + Q;                 // (Q)

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_k = N / kWarps;            // state rows per thread
  const float a = A[head];
  const T* xb = x + b * x_sb + head * P;
  const T* dtb = dt + b * dt_sb + head;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;
  const size_t y_st = static_cast<size_t>(nh) * P;
  T* yb = y + static_cast<size_t>(b) * seq * y_st + head * P;

  for (int e = threadIdx.x; e < N * P; e += kThreads) h_s[e] = 0.f;

  for (int t0 = 0; t0 < seq; t0 += Q) {
    __syncthreads();   // the previous chunk is done with x, B and h
    for (int e = threadIdx.x; e < Q * P; e += kThreads) {
      const int j = e / P;
      x_s[e] = ld(xb + (t0 + j) * x_st + (e - j * P));
    }
    for (int e = threadIdx.x; e < Q * N; e += kThreads) {
      const int j = e / N;
      const int n = e - j * N;
      b_s[j * NS + n] = ld(bb + (t0 + j) * b_st + n);
    }
    for (int j = threadIdx.x; j < Q; j += kThreads)
      dt_s[j] = ld(dtb + (t0 + j) * dt_st);
    __syncthreads();

    if (warp == 0) {   // cum: inclusive cumsum of dt A, 4 tokens a lane
      float part[4];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = lane * 4 + i;
        run += j < Q ? dt_s[j] * a : 0.f;
        part[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(kFullMask, incl, off);
        if (lane >= off) incl += up;
      }
      const float before = incl - run;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = lane * 4 + i;
        if (j < Q) cum_s[j] = before + part[i];
      }
    }
    __syncthreads();
    const float cum_last = cum_s[Q - 1];
    for (int j = threadIdx.x; j < Q; j += kThreads)
      w_s[j] = expf(cum_last - cum_s[j]) * dt_s[j];

    for (int r0 = 0; r0 < Q; r0 += kTileRows) {
      const int rows = min(kTileRows, Q - r0);
      const int jmax = min(Q, r0 + kTileRows);   // columns a row can see
      __syncthreads();   // every warp is done with the previous C tile
      for (int e = threadIdx.x; e < rows * N; e += kThreads) {
        const int i = e / N;
        const int n = e - i * N;
        c_s[i * NS + n] = ld(cb + (t0 + r0 + i) * c_st + n);
      }
      __syncthreads();

      // scores C_i . B_j of this warp's 4 rows, columns lane + 32 jj
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(warp * 4 + i) * NS + n];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (32 * jj >= jmax) break;
          const float bv = b_s[min(lane + 32 * jj, Q - 1) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][jj] = fmaf(cv[i], bv, s[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int il = warp * 4 + i;
        const int ig = r0 + il;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = lane + 32 * jj;
          if (j >= jmax) break;
          float val = 0.f;
          if (ig < Q && j <= ig)
            val = s[i][jj] * expf(cum_s[ig] - cum_s[j]) * dt_s[j];
          s_s[il * SS + j] = val;
        }
      }
      __syncwarp();

      // y_i = scores_i . x + exp(cum_i) C_i . h_prev
      float yi[4][kPC], yo[4][kPC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int pc = 0; pc < kPC; ++pc) yi[i][pc] = yo[i][pc] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float sv[4], xv[kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = s_s[(warp * 4 + i) * SS + j];
#pragma unroll
        for (int pc = 0; pc < kPC; ++pc) xv[pc] = x_s[j * P + lane + 32 * pc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int pc = 0; pc < kPC; ++pc)
            yi[i][pc] = fmaf(sv[i], xv[pc], yi[i][pc]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[kPC];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(warp * 4 + i) * NS + n];
#pragma unroll
        for (int pc = 0; pc < kPC; ++pc) hv[pc] = h_s[n * P + lane + 32 * pc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int pc = 0; pc < kPC; ++pc)
            yo[i][pc] = fmaf(cv[i], hv[pc], yo[i][pc]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int il = warp * 4 + i;
        if (il >= rows) continue;
        const int ig = r0 + il;
        const float e = expf(cum_s[ig]);
        T* yp = yb + (t0 + ig) * y_st;
#pragma unroll
        for (int pc = 0; pc < kPC; ++pc)
          st(yp + lane + 32 * pc, yi[i][pc] + e * yo[i][pc]);
      }
    }

    __syncthreads();   // every warp is done reading h and the raw B
    for (int e = threadIdx.x; e < Q * N; e += kThreads) {
      const int j = e / N;
      b_s[j * NS + (e - j * N)] *= w_s[j];
    }
    __syncthreads();

    // h = exp(cum_last) h + (B w)^T x: rows warp + 8 k, columns lane + 32 pc
    const float decay = expf(cum_last);
    float acc[kMaxK][kPC];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
#pragma unroll
      for (int pc = 0; pc < kPC; ++pc)
        acc[k][pc] = k < n_k
            ? decay * h_s[(warp + kWarps * k) * P + lane + 32 * pc] : 0.f;
    for (int j = 0; j < Q; ++j) {
      float xv[kPC];
#pragma unroll
      for (int pc = 0; pc < kPC; ++pc) xv[pc] = x_s[j * P + lane + 32 * pc];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= n_k) break;
        const float bw = b_s[j * NS + warp + kWarps * k];
#pragma unroll
        for (int pc = 0; pc < kPC; ++pc) acc[k][pc] = fmaf(bw, xv[pc], acc[k][pc]);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= n_k) break;
#pragma unroll
      for (int pc = 0; pc < kPC; ++pc)
        h_s[(warp + kWarps * k) * P + lane + 32 * pc] = acc[k][pc];
    }
  }

  __syncthreads();
  T* hb = h_final + (static_cast<size_t>(b) * nh + head) * N * P;
  for (int e = threadIdx.x; e < N * P; e += kThreads) st(hb + e, h_s[e]);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, void* h_final,
                   int B, int seq, int nh, int N, int Q,
                   const long long* strides, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(N) * P + Q * P + Q * (N + 1) +
       kTileRows * (N + 1) + kTileRows * (Q + 1) + 3 * Q);
  auto kernel = ssd_scan_kernel<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nh, B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), static_cast<T*>(h_final), seq, nh, N, Q,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, void* h_final,
                     int B, int seq, int nh, int P, int N, int Q,
                     const long long* strides, cudaStream_t stream) {
  switch (P) {
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, h_final, B, seq, nh, N, Q,
                           strides, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, h_final, B, seq, nh, N, Q,
                           strides, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, seq, nh, P), dt (B, seq, nh), B_mat and C_mat (B, seq, N), all of
// one dtype (dtype 0: float32, 1: bfloat16), given by their batch and time
// strides in elements (x's heads P apart, every innermost axis dense); A
// (nh,) float32.  y (B, seq, nh, P) and h_final (B, nh, N, P): contiguous,
// x's dtype.  P in {32, 64}; N a multiple of 8 up to 128; 1 <= Q <= 128
// and seq % Q == 0.  Launches on `stream` of device `device` and returns
// the launch's cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            void* h_final, int B, int seq, int nh, int P,
                            int N, int Q, long long x_sb, long long x_st,
                            long long dt_sb, long long dt_st, long long b_sb,
                            long long b_st, long long c_sb, long long c_st,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || Q > kMaxChunk || N < 8 || N > kMaxState || N % kWarps ||
      seq % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[8] = {x_sb, x_st, dt_sb, dt_st,
                                b_sb, b_st, c_sb, c_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(x, dt, A, Bm, Cm, y, h_final, B, seq, nh, P, N, Q,
                          strides, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_final, B, seq, nh,
                                  P, N, Q, strides, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
