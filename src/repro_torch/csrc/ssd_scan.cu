// Chunked SSD (Mamba2) selective scan (K9) for Hopper, sm_90a: float32 or
// bfloat16 in and out, float32 arithmetic throughout, the products on the
// TF32 tensor cores to float32 accuracy (3xTF32, csrc/tf32x3.cuh).
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
// What bounds it on this card: operations.  B and C are one group shared
// by every head, so C B^T depends on (b, chunk) only and its causal half,
// Q (Q + 1) N, counts once per (b, chunk); per (b, head, chunk) the
// causal half of scores . x, Q (Q + 1) P, and the readout and the state
// update, 4 Q N P.  At Mamba2-1.3B's prefill shape (B 2, T 2048, nh 64,
// P 64, N 128, Q 128) that is 10.82 GFLOP; each float32 product is three
// TF32 products, so 3 x 10.82 GFLOP at 495 TFLOP/s = 0.0656 ms, against
// 0.144 GB of x, dt, B, C, y and the final state (0.043 ms at 3.35 TB/s).
// On the SIMT float32 cores the same work takes 0.162 ms.
//
// The Pallas grid walks the chunks of a (b, head) in order, carrying h in
// VMEM.  Here the standard Mamba2 split into chunk-parallel passes lets
// every chunk be worked on at once (16 x 2 x 64 = 2048 blocks of a pass
// at that shape, where one block per (head, b) walked 16 chunks before):
// 0. C B^T, grid (chunk, b, group of kCbRows query rows), once for all
//    heads, its causal 16 x 8 tiles into float32 scratch (2 MB);
// 1. chunk states, grid (chunk, b, group of kStateHeads heads): for each
//    head s_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j (N x P) and
//    the chunk's decay exp(cum_last), into float32 scratch (67 MB);
// 2. state passing, grid (tile of N P, head, b): serially over the
//    chunks, h_in[c] = h; h = decay_c h + s_c, written over s in place,
//    and h after the last chunk as the final state (bound by bytes);
// 3. chunk scan, grid (chunk, b, head): y = exp(cum_i) (C h_in) + scores
//    . x, scores_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j for j <= i.
// The wrapper allocates the scratch; the kernels allocate nothing and the
// passes follow each other on the stream with no host synchronisation.
//
// What the design does:
// * Every product is mma.sync m16n8k8 in the 3xTF32 split.  A warp owns
//   16 output rows (state rows in pass 1, query rows in passes 0 and 3).
//   The operand every warp of a block reads (x, h_in, B in pass 0) is
//   staged in shared memory; the operand only one warp reads (its rows of
//   B, of C, of C B^T) comes from device memory (L2) one k step ahead.
//   The sum dimension is permuted (fragment columns t, t + 4 <-> rows
//   2t, 2t + 1) so that C and C B^T fragments are 64-bit loads, and the
//   C B^T accumulator of keys 8 jt + 2t, + 1 becomes the A fragment of
//   scores . x where it lies, as in K3.  Rows are padded (x, h_in: P + 4
//   floats; B, C in pass 0: N + 8) so fragment loads are free of bank
//   conflicts.
// * Staging is cp.async for float32 rows aligned to 16 bytes (the strided
//   views of xBC are); bfloat16 is widened to float32 at staging, 4
//   values a load, and takes the same 3xTF32 path.  Pass 1 stages the
//   next head's x while this head's products run.
// * Key tiles wholly above the diagonal are skipped; a ragged Q (not a
//   multiple of 16) is zero-padded to 16 in shared memory and never
//   written.
//
// Left for later work: wgmma with TMA loads, and fusing the passes (a
// look-back across chunks) so that the 67 MB of chunk states never
// reach device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;          // passes 1 and 3: 8 warps
constexpr int kCbRows = 64;            // pass 0: query rows a block
constexpr int kCbThreads = 2 * kCbRows;  // pass 0: a warp per 16 rows
constexpr int kMaxChunk = 128;
constexpr int kMaxState = 128;
constexpr int kTiles = kMaxChunk / 8;  // key n8 tiles of a chunk
constexpr int kStateHeads = 4;         // heads per block in pass 1
constexpr int kPassChunks = 16;        // chunks loaded ahead in pass 2
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

template <typename T>
struct Args {
  const T* x;            // (B, seq, nh, P), batch / time strides below
  const T* dt;           // (B, seq, nh)
  const float* A;        // (nh,)
  const T* Bm;           // (B, seq, N)
  const T* Cm;           // (B, seq, N)
  T* y;                  // (B, seq, nh, P), contiguous
  T* h_final;            // (B, nh, N, P), contiguous
  float* cb;             // (B, nc, Qp, Qp) scratch: C B^T, causal tiles
  float* states;         // (B, nc, nh, N, P) scratch: s_c, then h_in
  float* decay;          // (B, nc, nh) scratch: exp(cum_last)
  int seq, nh, N, Q, nc;
  int vec;               // rows of x, B, C aligned to 4 values
  long long x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st;
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

// rows [0, rows_p) x columns [0, cols_p) of a (rows, cols) matrix whose
// rows are row_stride apart into a tile of `stride`-float rows; the
// padding rows and columns are zero.  cols, cols_p and stride are
// multiples of 4.  With `vec` (rows aligned to 4 values) the copies move
// 4 values each: float32 by cp.async, complete after cp_async_wait_all();
// bfloat16 as one 8-byte load, widened to float32.  Else one at a time.
template <typename T>
__device__ __forceinline__ void stage(float* tile, int stride, const T* base,
                                      long long row_stride, int rows,
                                      int rows_p, int cols, int cols_p,
                                      bool vec) {
  if (vec) {
    const int per_row = cols_p / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows_p * per_row; e += blockDim.x) {
      const int r = e / per_row;
      const int c = (e - r * per_row) * 4;
      const bool valid = r < rows && c < cols;
      const T* src = valid ? base + r * row_stride + c : base;
      if constexpr (std::is_same<T, float>::value) {
        cp_async16(tile + r * stride + c, src, valid);
      } else {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (valid) {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.y));
          v = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        *reinterpret_cast<float4*>(tile + r * stride + c) = v;
      }
    }
    return;
  }
#pragma unroll 4
  for (int e = threadIdx.x; e < rows_p * cols_p; e += blockDim.x) {
    const int r = e / cols_p;
    const int c = e - r * cols_p;
    tile[r * stride + c] =
        r < rows && c < cols ? ld(base + r * row_stride + c) : 0.f;
  }
}

// dt of one head for the chunk starting at t0, zero past Q
template <typename T>
__device__ __forceinline__ void stage_dt(float* dt_s, const Args<T>& a, int b,
                                        long long t0, int head, int Qp) {
  const T* base = a.dt + b * a.dt_sb + t0 * a.dt_st + head;
  for (int j = threadIdx.x; j < Qp; j += blockDim.x)
    dt_s[j] = j < a.Q ? ld(base + j * a.dt_st) : 0.f;
}

// one warp: cum_s[j] = sum_{i <= j} dt_s[i] a, 4 tokens a lane (Qp <= 128;
// dt is zero past Q, so cum stays at cum[Q - 1] there)
__device__ __forceinline__ void chunk_cum(const float* dt_s, float a,
                                          float* cum_s, int Qp, int lane) {
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = lane * 4 + i;
    run += j < Qp ? dt_s[j] * a : 0.f;
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
    if (j < Qp) cum_s[j] = before + part[i];
  }
}

// the A fragment of rows r, r + 8 of a row-major matrix at columns
// k0 + 2t, k0 + 2t + 1 (fragment columns t, t + 4), split for 3xTF32
__device__ __forceinline__ void a_fragment(float lo0, float lo1, float hi0,
                                           float hi1, uint32_t big[4],
                                           uint32_t small[4]) {
  split(lo0, big[0], small[0]);
  split(hi0, big[1], small[1]);
  split(lo1, big[2], small[2]);
  split(hi1, big[3], small[3]);
}

// acc[nt] += A . B over the 8 rows k0 + 2t, k0 + 2t + 1 (t = 0..3) of the
// shared B tile `rows` (a row-major (K, 8 NT) tile of stride `stride`,
// read at columns 8 nt + g)
template <int NT>
__device__ __forceinline__ void mma_rows(float acc[NT][4],
                                         const uint32_t a_big[4],
                                         const uint32_t a_small[4],
                                         const float* rows, int stride) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t b_big[2], b_small[2];
    split(rows[8 * nt], b_big[0], b_small[0]);
    split(rows[8 * nt + stride], b_big[1], b_small[1]);
    mma_3xtf32(acc[nt], a_big, a_small, b_big, b_small);
  }
}

// ---- pass 0: C B^T --------------------------------------------------------

// grid (chunk, b, group of kCbRows query rows), a warp per 16 rows: warp
// w computes query rows i0 .. i0 + 15 against the keys 8 jt .. 8 jt + 7
// with 8 jt <= i0 + 15 (the causal tiles), once for every head
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
chunk_cb_kernel(Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int Qp = round16(a.Q);
  const int Np = round16(a.N);
  const int CS = Np + 8;                 // 64-bit loads at (row g, col 2t)
  const int r_lo = kCbRows * blockIdx.z;
  const int keys = min(Qp, r_lo + kCbRows);   // the keys these rows see
  float* c_s = smem;                     // (kCbRows, Np + 8)
  float* b_s = c_s + kCbRows * CS;       // (keys, Np + 8)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long t0 = static_cast<long long>(c) * a.Q;

  stage(c_s, CS, a.Cm + b * a.c_sb + (t0 + r_lo) * a.c_st, a.c_st,
        a.Q - r_lo, min(kCbRows, Qp - r_lo), a.N, Np, a.vec);
  stage(b_s, CS, a.Bm + b * a.b_sb + t0 * a.b_st, a.b_st, a.Q, keys, a.N,
        Np, a.vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int i0 = r_lo + 16 * warp;
  if (i0 >= Qp) return;
  const float* cr = c_s + (16 * warp + g) * CS + 2 * t;
  float cb[kTiles][4];
#pragma unroll
  for (int jt = 0; jt < kTiles; ++jt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[jt][e] = 0.f;
  for (int k0 = 0; k0 < Np; k0 += 8) {
    const float2 lo = *reinterpret_cast<const float2*>(cr + k0);
    const float2 hi = *reinterpret_cast<const float2*>(cr + 8 * CS + k0);
    uint32_t a_big[4], a_small[4];
    a_fragment(lo.x, lo.y, hi.x, hi.y, a_big, a_small);
#pragma unroll
    for (int jt = 0; jt < kTiles; ++jt) {
      if (8 * jt > i0 + 15) break;
      const float2 bv = *reinterpret_cast<const float2*>(
          b_s + (8 * jt + g) * CS + k0 + 2 * t);
      uint32_t b_big[2], b_small[2];
      split(bv.x, b_big[0], b_small[0]);
      split(bv.y, b_big[1], b_small[1]);
      mma_3xtf32(cb[jt], a_big, a_small, b_big, b_small);
    }
  }
  float* out = a.cb + (static_cast<size_t>(b) * a.nc + c) * Qp * Qp +
               (i0 + g) * Qp + 2 * t;
#pragma unroll
  for (int jt = 0; jt < kTiles; ++jt) {
    if (8 * jt > i0 + 15) break;
    store2(out + 8 * jt, cb[jt][0], cb[jt][1]);
    store2(out + 8 * Qp + 8 * jt, cb[jt][2], cb[jt][3]);
  }
}

// ---- pass 1: chunk states -------------------------------------------------

// grid (chunk, b, group of kStateHeads heads), 8 warps: for each head,
// warp w computes state rows 16 w .. 16 w + 15 (an m16 tile; Np / 16 <= 8
// tiles) of s = (B w)^T x, all P columns.  Its A fragments (B scaled by
// w) come from device memory (each warp reads its own state columns of
// B); x, which every warp reads, is staged, the next head's while this
// head's products run.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
chunk_states_kernel(Args<T> a) {
  constexpr int kXS = P + 4;             // 32-bit loads at (row 2t, col g)
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = blockIdx.z * kStateHeads;
  const int heads = min(kStateHeads, a.nh - h0);
  const int Qp = round16(a.Q);
  const int Np = round16(a.N);
  float* x_s = smem;                     // (2, Qp, P + 4): two slots
  float* dt_s = x_s + 2 * Qp * kXS;      // (kStateHeads, Qp)
  float* w_s = dt_s + kStateHeads * Qp;  // (kStateHeads, Qp): cum, then w
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long t0 = static_cast<long long>(c) * a.Q;
  const T* xb = a.x + b * a.x_sb + t0 * a.x_st + h0 * P;

  stage(x_s, kXS, xb, a.x_st, a.Q, Qp, P, P, a.vec);
  cp_async_commit();
  for (int k = 0; k < heads; ++k)
    stage_dt(dt_s + k * Qp, a, b, t0, h0 + k, Qp);
  __syncthreads();
  if (warp < heads) {
    float* w = w_s + warp * Qp;
    const float* dt = dt_s + warp * Qp;
    chunk_cum(dt, a.A[h0 + warp], w, Qp, lane);
    __syncwarp();
    const float last = w[Qp - 1];
    __syncwarp();
    for (int j = lane; j < Qp; j += 32) w[j] = expf(last - w[j]) * dt[j];
    if (lane == 0)
      a.decay[(static_cast<size_t>(b) * a.nc + c) * a.nh + h0 + warp] =
          expf(last);
  }

  const int m0 = 16 * warp;
  const T* bb = a.Bm + b * a.b_sb + t0 * a.b_st + 2 * t * a.b_st;
  const int n0 = m0 + g, n1 = m0 + g + 8;
  // B at tokens k0 + 2t, k0 + 2t + 1 and state rows n0, n1 (zero past Q
  // and N), loaded one k step ahead of its products
  auto load_b = [&](int k0, float v[4]) {
    const T* r = bb + k0 * a.b_st;
    const bool q0 = k0 + 2 * t < a.Q, q1 = k0 + 2 * t + 1 < a.Q;
    v[0] = q0 && n0 < a.N ? ld(r + n0) : 0.f;
    v[1] = q1 && n0 < a.N ? ld(r + a.b_st + n0) : 0.f;
    v[2] = q0 && n1 < a.N ? ld(r + n1) : 0.f;
    v[3] = q1 && n1 < a.N ? ld(r + a.b_st + n1) : 0.f;
  };
  for (int k = 0; k < heads; ++k) {
    cp_async_wait_all();   // head k's x is in
    __syncthreads();       // ... for every warp; w is in; the other slot
                           // is free
    if (k + 1 < heads) {
      stage(x_s + ((k + 1) & 1) * Qp * kXS, kXS, xb + (k + 1) * P, a.x_st,
            a.Q, Qp, P, P, a.vec);
      cp_async_commit();
    }
    if (m0 >= Np) continue;
    const float* xk = x_s + (k & 1) * Qp * kXS + g;
    const float* w = w_s + k * Qp;
    float acc[P / 8][4];
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    float next[4];
    load_b(0, next);
    for (int k0 = 0; k0 < Qp; k0 += 8) {
      // fragment column t <-> token j0 = k0 + 2t, column t + 4 <-> j0 + 1
      const float cur[4] = {next[0], next[1], next[2], next[3]};
      if (k0 + 8 < Qp) load_b(k0 + 8, next);
      const int j0 = k0 + 2 * t;
      const float w0 = w[j0], w1 = w[j0 + 1];
      uint32_t a_big[4], a_small[4];
      a_fragment(cur[0] * w0, cur[1] * w1, cur[2] * w0, cur[3] * w1, a_big,
                 a_small);
      mma_rows<P / 8>(acc, a_big, a_small, xk + j0 * kXS, kXS);
    }
    float* s = a.states +
               ((static_cast<size_t>(b) * a.nc + c) * a.nh + h0 + k) * a.N * P +
               2 * t;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      if (n0 < a.N) store2(s + n0 * P + 8 * nt, acc[nt][0], acc[nt][1]);
      if (n1 < a.N) store2(s + n1 * P + 8 * nt, acc[nt][2], acc[nt][3]);
    }
  }
}

// ---- pass 2: state passing ------------------------------------------------

// grid (tile of N P, head, b): four consecutive entries of h a thread; the
// chunks' states are loaded kPassChunks at a time ahead of the serial
// update
template <typename T>
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ decay,
                  T* __restrict__ h_final, int nh, int nc, int NP) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  if (e >= NP) return;
  const size_t step = static_cast<size_t>(nh) * NP / 4;   // chunk to chunk
  float4* s = reinterpret_cast<float4*>(
      states + (static_cast<size_t>(b) * nc * nh + head) * NP + e);
  const float* d = decay + static_cast<size_t>(b) * nc * nh + head;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassChunks) {
    float4 v[kPassChunks];
    float dv[kPassChunks];
#pragma unroll
    for (int i = 0; i < kPassChunks; ++i) {
      if (c0 + i < nc) {
        v[i] = s[(c0 + i) * step];
        dv[i] = d[(c0 + i) * nh];
      }
    }
#pragma unroll
    for (int i = 0; i < kPassChunks; ++i) {
      if (c0 + i < nc) {
        s[(c0 + i) * step] = h;
        h = make_float4(fmaf(dv[i], h.x, v[i].x), fmaf(dv[i], h.y, v[i].y),
                        fmaf(dv[i], h.z, v[i].z), fmaf(dv[i], h.w, v[i].w));
      }
    }
  }
  T* out = h_final + (static_cast<size_t>(b) * nh + head) * NP + e;
  st(out, h.x);
  st(out + 1, h.y);
  st(out + 2, h.z);
  st(out + 3, h.w);
}

// ---- pass 3: chunk scan ---------------------------------------------------

// grid (chunk, b, head), 8 warps: warp w computes query rows i0 = 16 w ..
// i0 + 15, y = exp(cum_i) (C h_in) + scores . x.  C's A fragments come
// from device memory, and so does C B^T (pass 0), where each warp reads
// its own rows; x and h_in, which every warp reads, are staged.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 3)
chunk_scan_kernel(Args<T> a) {
  constexpr int kXS = P + 4;
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int head = blockIdx.z;
  const int Qp = round16(a.Q);
  const int Np = round16(a.N);
  float* x_s = smem;                     // (Qp, P + 4)
  float* h_s = x_s + Qp * kXS;           // (Np, P + 4)
  float* dt_s = h_s + Np * kXS;          // (Qp)
  float* cum_s = dt_s + Qp;              // (Qp)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long t0 = static_cast<long long>(c) * a.Q;
  const size_t chunk_head =
      (static_cast<size_t>(b) * a.nc + c) * a.nh + head;

  stage(x_s, kXS, a.x + b * a.x_sb + t0 * a.x_st + head * P, a.x_st, a.Q,
        Qp, P, P, a.vec);
  stage(h_s, kXS, a.states + chunk_head * a.N * P, P, a.N, Np, P, P, true);
  cp_async_commit();
  stage_dt(dt_s, a, b, t0, head, Qp);
  __syncthreads();
  if (warp == 0) chunk_cum(dt_s, a.A[head], cum_s, Qp, lane);
  cp_async_wait_all();
  __syncthreads();

  const int i0 = 16 * warp;
  if (i0 >= Qp) return;
  const int r0 = i0 + g;                 // this lane's rows: r0, r0 + 8
  const T* c0p = a.Cm + b * a.c_sb + (t0 + r0) * a.c_st + 2 * t;
  const T* c1p = c0p + 8 * a.c_st;
  const bool v0 = r0 < a.Q, v1 = r0 + 8 < a.Q;
  // C at rows r0, r0 + 8 and state columns k0 + 2t, + 1 (zero past Q and
  // N; N is a multiple of 8), loaded one k step ahead of its products
  auto load_c = [&](int k0, float v[4]) {
    const bool kv = k0 + 2 * t < a.N;
    v[0] = v0 && kv ? ld(c0p + k0) : 0.f;
    v[1] = v0 && kv ? ld(c0p + k0 + 1) : 0.f;
    v[2] = v1 && kv ? ld(c1p + k0) : 0.f;
    v[3] = v1 && kv ? ld(c1p + k0 + 1) : 0.f;
  };
  float acc[P / 8][4];
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;
  // C h_in (state rows k0 + 2t, k0 + 2t + 1: fragment rows t, t + 4)
  float next[4];
  load_c(0, next);
  for (int k0 = 0; k0 < Np; k0 += 8) {
    const float cur[4] = {next[0], next[1], next[2], next[3]};
    if (k0 + 8 < Np) load_c(k0 + 8, next);
    uint32_t a_big[4], a_small[4];
    a_fragment(cur[0], cur[1], cur[2], cur[3], a_big, a_small);
    mma_rows<P / 8>(acc, a_big, a_small, h_s + (k0 + 2 * t) * kXS + g, kXS);
  }
  // ... scaled by exp(cum_i) ...
  const float cum0 = cum_s[r0], cum1 = cum_s[r0 + 8];
  const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
    acc[pt][0] *= e0;
    acc[pt][1] *= e0;
    acc[pt][2] *= e1;
    acc[pt][3] *= e1;
  }
  // ... + scores . x, scores_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j for
  // j <= i: the C B^T fragment of keys 8 jt + 2t, + 1 becomes the A
  // fragment of columns t, t + 4, and x is read at the same keys
  const float* cbr = a.cb + (static_cast<size_t>(b) * a.nc + c) * Qp * Qp +
                     r0 * Qp + 2 * t;
  const int last_tile = (i0 + 15) / 8;
  float2 s0 = *reinterpret_cast<const float2*>(cbr);
  float2 s1 = *reinterpret_cast<const float2*>(cbr + 8 * Qp);
#pragma unroll
  for (int jt = 0; jt < kTiles; ++jt) {
    if (jt > last_tile) break;
    const float2 cs0 = s0, cs1 = s1;     // the next tile's, one ahead
    if (jt < last_tile) {
      s0 = *reinterpret_cast<const float2*>(cbr + 8 * jt + 8);
      s1 = *reinterpret_cast<const float2*>(cbr + 8 * Qp + 8 * jt + 8);
    }
    const int j0 = 8 * jt + 2 * t;
    const float cj0 = cum_s[j0], cj1 = cum_s[j0 + 1];
    const float d0 = dt_s[j0], d1 = dt_s[j0 + 1];
    uint32_t a_big[4], a_small[4];
    a_fragment(j0 <= r0 ? cs0.x * expf(cum0 - cj0) * d0 : 0.f,
               j0 + 1 <= r0 ? cs0.y * expf(cum0 - cj1) * d1 : 0.f,
               j0 <= r0 + 8 ? cs1.x * expf(cum1 - cj0) * d0 : 0.f,
               j0 + 1 <= r0 + 8 ? cs1.y * expf(cum1 - cj1) * d1 : 0.f,
               a_big, a_small);
    mma_rows<P / 8>(acc, a_big, a_small, x_s + j0 * kXS + g, kXS);
  }
  const size_t y_st = static_cast<size_t>(a.nh) * P;
  T* yb = a.y + (static_cast<size_t>(b) * a.seq + t0) * y_st + head * P +
          2 * t;
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
    if (v0) store2(yb + r0 * y_st + 8 * pt, acc[pt][0], acc[pt][1]);
    if (v1) store2(yb + (r0 + 8) * y_st + 8 * pt, acc[pt][2], acc[pt][3]);
  }
}

// dynamic shared memory of passes 0, 1 and 3, in bytes
size_t cb_smem(int Q, int N) {
  const int Qp = round16(Q), Np = round16(N);
  return sizeof(float) * static_cast<size_t>(kCbRows + Qp) * (Np + 8);
}
size_t states_smem(int Q, int P) {
  const int Qp = round16(Q);
  return sizeof(float) * static_cast<size_t>(Qp) *
         (2 * (P + 4) + 2 * kStateHeads);
}
size_t scan_smem(int Q, int N, int P) {
  const int Qp = round16(Q), Np = round16(N);
  return sizeof(float) * (static_cast<size_t>(Qp + Np) * (P + 4) + 2 * Qp);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int P>
cudaError_t launch(const Args<T>& a, int B, cudaStream_t stream) {
  const int Qp = round16(a.Q);
  const size_t s0 = cb_smem(a.Q, a.N);
  const size_t s1 = states_smem(a.Q, P);
  const size_t s3 = scan_smem(a.Q, a.N, P);
  cudaError_t err = allow_smem(chunk_cb_kernel<T>, s0);
  if (err == cudaSuccess) err = allow_smem(chunk_states_kernel<T, P>, s1);
  if (err == cudaSuccess) err = allow_smem(chunk_scan_kernel<T, P>, s3);
  if (err != cudaSuccess) return err;
  chunk_cb_kernel<T><<<dim3(a.nc, B, (Qp + kCbRows - 1) / kCbRows),
                       kCbThreads, s0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_states_kernel<T, P><<<dim3(a.nc, B, (a.nh + kStateHeads - 1) /
                                                 kStateHeads),
                              kThreads, s1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int NP = a.N * P;
  state_pass_kernel<T><<<dim3((NP + 4 * kThreads - 1) / (4 * kThreads),
                              a.nh, B),
                         kThreads, 0, stream>>>(a.states, a.decay, a.h_final,
                                                a.nh, a.nc, NP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chunk_scan_kernel<T, P><<<dim3(a.nc, B, a.nh), kThreads, s3, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
bool aligned4(const void* p) {      // to 4 values of T
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, void* h_final,
                     float* cb, float* states, float* decay, int B, int seq,
                     int nh, int P, int N, int Q, const long long* s,
                     cudaStream_t stream) {
  // staging 4 values a copy: rows of x, B and C aligned to 4 values
  const bool vec = aligned4<T>(x) && aligned4<T>(Bm) && aligned4<T>(Cm) &&
                   (s[0] | s[1] | s[4] | s[5] | s[6] | s[7]) % 4 == 0;
  const Args<T> a{static_cast<const T*>(x), static_cast<const T*>(dt), A,
                  static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                  static_cast<T*>(y), static_cast<T*>(h_final), cb, states,
                  decay, seq, nh, N, Q, seq / Q, vec,
                  s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  switch (P) {
    case 32:
      return launch<T, 32>(a, B, stream);
    case 64:
      return launch<T, 64>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, seq, nh, P), dt (B, seq, nh), B_mat and C_mat (B, seq, N), all of
// one dtype (dtype 0: float32, 1: bfloat16), given by their batch and time
// strides in elements (x's heads P apart, every innermost axis dense); A
// (nh,) float32.  y (B, seq, nh, P) and h_final (B, nh, N, P): contiguous,
// x's dtype.  Float32 scratch: cb (B, seq / Q, Qp, Qp) with Qp = Q rounded
// up to 16, states (B, seq / Q, nh, N, P) and decay (B, seq / Q, nh).
// P in {32, 64}; N a multiple of 8 up to 128; 1 <= Q <= 128 and
// seq % Q == 0.  Launches the four passes on `stream` of device `device`
// and returns the first failing launch's cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const float* A,
                            const void* Bm, const void* Cm, void* y,
                            void* h_final, float* cb, float* states,
                            float* decay, int B, int seq, int nh, int P,
                            int N, int Q, long long x_sb, long long x_st,
                            long long dt_sb, long long dt_st, long long b_sb,
                            long long b_st, long long c_sb, long long c_st,
                            int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q < 1 || Q > kMaxChunk || N < 8 || N > kMaxState || N % 8 || seq % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[8] = {x_sb, x_st, dt_sb, dt_st,
                                b_sb, b_st, c_sb, c_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch<float>(x, dt, A, Bm, Cm, y, h_final, cb, states, decay, B,
                          seq, nh, P, N, Q, strides, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_final, cb, states,
                                  decay, B, seq, nh, P, N, Q, strides, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
