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
// element of p.v for each of the group's query heads), far below the
// H100's ~20 FLOP/byte float32 ridge, so the least time is the live K/V
// bytes over 3.35 TB/s (H100 SXM data sheet, at its 700 W limit): 0.025 ms
// for Qwen2.5-3B's decode geometry at 4096-16384 positions a row (84 MB).
// At the serve path's short contexts that least time is below the time
// of one kernel launch.
//
// What the design does about it (flash-decoding):
// * The page loop is split across blocks.  The grid is (B, KV, S): split
//   s of row b takes the pages [s span, (s + 1) span) of the row's live
//   extent, where span is chosen by the caller from the table width M and
//   the SM count (about four blocks an SM), never from lengths, so the
//   caller needs no device-to-host copy.  A split that starts past the
//   live extent exits at once.
// * A block serves all H/KV query heads of its KV head, so each page's K
//   and V are read from device memory once per group.  The split's page
//   ids go to shared memory first (one round trip), then its pages are
//   staged by cp.async 16-byte copies into a four-page ring: pages j + 1
//   .. j + 3 load while page j computes.
// * Positions in parallel: a group of 8 lanes owns one position of the
//   page and scores it against every query head of the group (each lane
//   a strided quarter of the head dimension, then three shuffles), so a
//   page's scores take one pass, not one dependent chain per position.
//   Then 8 lanes a head take the page's max, the correction and the
//   probabilities (one rescale a page), and every thread folds the page
//   into its (head, 4-column) slices of the accumulator.
// * The partials (m, l, unnormalised acc) of the splits go to scratch and
//   a second kernel combines them, one block a (row, head), over the
//   row's non-empty splits (the first ceil(ceil(lengths[b] / ps) / span),
//   found from lengths on the device): each thread sums a fixed subset of
//   splits and the subsets are added in a fixed order, with no atomics,
//   so the result is bitwise the same from run to run.  With one split
//   the first kernel writes the output itself.
// * The block reads its own table row and length (the TPU kernel's scalar
//   prefetch) and stops at ceil(length / ps) pages: dead pages are never
//   read.  Masked positions contribute exactly 0 to l and acc in the
//   reference, so skipping them is exact.
// * Scores are kept in log2 units (q.k hd^-1/2 log2(e)) and exponentiated
//   with exp2.
//
// Precondition (the caller's, as on the serve path where
// lengths = min(pos + 1, max_pages * ps)): 1 <= lengths[b] <= M * ps and
// every table entry a live position reads is a page id in [0, P).  A page
// id outside [0, P) traps instead of reading foreign memory.
//
// Left for later work: bf16 pools (the reference has none).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanesPerPos = 8;       // lanes that score one position
constexpr int kPosPerPass = kThreads / kLanesPerPos;
constexpr int kHeadChunk = 8;         // query heads scored together
constexpr int kLanesPerHead = 8;      // lanes of one head's softmax
constexpr int kCombineThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int kStages = 4;            // pages in a block's cp.async ring

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 acc) {
  return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                     fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 div4(float4 a, float d) {
  return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
}

// page `page` of KV head kvh, K and V, into (ps, HD) tiles
template <int HD>
__device__ __forceinline__ void stage_page(float* k_s, float* v_s,
                                           const float* k_pool,
                                           const float* v_pool, int page,
                                           int ps, int KV, int kvh) {
  constexpr int kPerRow = HD / 4;
  const size_t base = (static_cast<size_t>(page) * ps * KV + kvh) * HD;
  for (int e = threadIdx.x; e < ps * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e - r * kPerRow) * 4;
    const size_t off = base + static_cast<size_t>(r) * KV * HD + c;
    cp_async16(k_s + r * HD + c, k_pool + off);
    cp_async16(v_s + r * HD + c, v_pool + off);
  }
}

// Thread layout of the accumulator: thread x owns the 4 columns
// 4 (x % (HD / 4)) .. + 3 of the heads x / (HD / 4) + kHeadsPerPass k.
template <int HD> struct AccLayout {
  static constexpr int kCols = HD / 4;
  static constexpr int kHeadsPerPass = kThreads / kCols;
  static constexpr int kSlots = 32 / kHeadsPerPass;   // group <= 32
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_split_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pool,
                   const float* __restrict__ v_pool,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int H, int KV, int P,
                   int ps, int M, int span, float scale_log2) {
  using L = AccLayout<HD>;
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int S = gridDim.z;
  const int G = H / KV;
  const int head0 = kvh * G;

  const int len = min(lengths[b], M * ps);
  const int n_pages = (len + ps - 1) / ps;
  const int first = split * span;
  const int last = min(first + span, n_pages);
  const int col = threadIdx.x % L::kCols;
  const int hrow = threadIdx.x / L::kCols;

  // past the live extent: nothing to do (the combine reads only the
  // splits below ceil(n_pages / span), from lengths)
  if (first >= last) return;

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                           // (G, HD)
  float* ring = q_s + G * HD;                  // kStages x (K, V) pages
  float* p_s = ring + kStages * 2 * ps * HD;   // (G, ps) scores, then p
  float* m_s = p_s + G * ps;                   // (G,) running max
  float* l_s = m_s + G;                        // (G,) running sum
  float* corr_s = l_s + G;                     // (G,) this page's rescale
  int* pages_s = reinterpret_cast<int*>(corr_s + G);   // (span,) page ids

  const int* row_table = table + static_cast<size_t>(b) * M;
  for (int i = threadIdx.x; i < last - first; i += kThreads) {
    const int page = row_table[first + i];
    if (page < 0 || page >= P) __trap();
    pages_s[i] = page;
  }
  __syncthreads();
  // page j goes to slot (j - first) % kStages; one commit group a page
  // (empty past the split), so that "page j is in" is always
  // cp.async.wait_group(kStages - 2) at the top of iteration j
  auto load_page = [&](int j) {
    if (j < last) {
      const int page = pages_s[j - first];
      float* slot = ring + ((j - first) % kStages) * 2 * ps * HD;
      stage_page<HD>(slot, slot + ps * HD, k_pool, v_pool, page, ps, KV,
                     kvh);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_page(first + i);
  const float4* q4 = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(b) * H + head0) * HD);
  for (int e = threadIdx.x; e < G * HD / 4; e += kThreads)
    reinterpret_cast<float4*>(q_s)[e] = q4[e];
  if (threadIdx.x < G) {
    m_s[threadIdx.x] = -CUDART_INF_F;
    l_s[threadIdx.x] = 0.f;
  }

  float4 acc[L::kSlots];
#pragma unroll
  for (int k = 0; k < L::kSlots; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int pos_lane = threadIdx.x % kLanesPerPos;
  const int pos_group = threadIdx.x / kLanesPerPos;

  for (int j = first; j < last; ++j) {
    const float* k_s = ring + ((j - first) % kStages) * 2 * ps * HD;
    const float* v_s = k_s + ps * HD;
    const int live = min(ps, len - j * ps);
    cp_async_wait<kStages - 2>();
    __syncthreads();   // page j is in; every thread is done with page j - 1
    load_page(j + kStages - 1);   // into page j - 1's slot

    // scores: 8 lanes a position, every head of the group (every warp
    // takes the same trip count, so the shuffles see full warps)
    for (int pos0 = 0; pos0 < ps; pos0 += kPosPerPass) {
      const int pos = pos0 + pos_group;
      const bool have = pos < ps;
      const float* kr = k_s + (have ? pos : 0) * HD;
      for (int hc = 0; hc < G; hc += kHeadChunk) {
        float dots[kHeadChunk];
#pragma unroll
        for (int hh = 0; hh < kHeadChunk; ++hh) dots[hh] = 0.f;
#pragma unroll
        for (int i = 0; i < HD / 32; ++i) {
          const int d = 4 * pos_lane + 32 * i;
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int hh = 0; hh < kHeadChunk; ++hh)
            if (hc + hh < G)
              dots[hh] = dot4(*reinterpret_cast<const float4*>(
                                  q_s + (hc + hh) * HD + d),
                              kv, dots[hh]);
        }
        float mine = 0.f;
#pragma unroll
        for (int hh = 0; hh < kHeadChunk; ++hh) {
          float v = dots[hh];
          v += __shfl_xor_sync(kFullMask, v, 1);
          v += __shfl_xor_sync(kFullMask, v, 2);
          v += __shfl_xor_sync(kFullMask, v, 4);
          if (hh == pos_lane) mine = v;
        }
        if (have && hc + pos_lane < G)
          p_s[(hc + pos_lane) * ps + pos] =
              pos < live ? mine * scale_log2 : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // softmax over the page: 8 lanes a head, every head at once (lanes
    // past the group read the last head and write nothing)
    for (int h0 = 0; h0 < G; h0 += kThreads / kLanesPerHead) {
      const int h = h0 + threadIdx.x / kLanesPerHead;
      const float* sc = p_s + min(h, G - 1) * ps;
      const int sub = threadIdx.x % kLanesPerHead;
      float mx = -CUDART_INF_F;
      for (int pos = sub; pos < ps; pos += kLanesPerHead)
        mx = fmaxf(mx, sc[pos]);
#pragma unroll
      for (int off = kLanesPerHead / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_old = m_s[min(h, G - 1)];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int pos = sub; pos < ps; pos += kLanesPerHead) {
        const float p = exp2f(sc[pos] - m_new);   // dead: 0
        if (h < G) p_s[h * ps + pos] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kLanesPerHead / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      if (h < G && sub == 0) {
        const float corr = exp2f(m_old - m_new);   // first page: 0
        corr_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v over the page's live positions
#pragma unroll
    for (int k = 0; k < L::kSlots; ++k) {
      const int h = hrow + L::kHeadsPerPass * k;
      if (h < G) acc[k] = scale4(acc[k], corr_s[h]);
    }
#pragma unroll 4
    for (int pos = 0; pos < live; ++pos) {
      const float4 vv = reinterpret_cast<const float4*>(v_s + pos * HD)[col];
#pragma unroll
      for (int k = 0; k < L::kSlots; ++k) {
        const int h = hrow + L::kHeadsPerPass * k;
        if (h < G) acc[k] = fma4(p_s[h * ps + pos], vv, acc[k]);
      }
    }
  }
  __syncthreads();   // m_s, l_s final

#pragma unroll
  for (int k = 0; k < L::kSlots; ++k) {
    const int h = hrow + L::kHeadsPerPass * k;
    if (h >= G) continue;
    const size_t bh = static_cast<size_t>(b) * H + head0 + h;
    if (S == 1)
      reinterpret_cast<float4*>(out + bh * HD)[col] =
          div4(acc[k], fmaxf(l_s[h], 1e-30f));
    else
      reinterpret_cast<float4*>(acc_part + (bh * S + split) * HD)[col] =
          acc[k];
  }
  if (S > 1 && threadIdx.x < G) {
    const size_t i = (static_cast<size_t>(b) * H + head0 + threadIdx.x) * S
                     + split;
    m_part[i] = m_s[threadIdx.x];
    l_part[i] = l_s[threadIdx.x];
  }
}

// out[b, h] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = 2^(m_s - max_s m_s), over the row's non-empty splits (they are the
// first ceil(ceil(len / ps) / span)).  One block a (row, head): thread
// (r, c) sums the 4-column slice c over the splits r, r + kGroups, ...,
// then the groups' sums are added in order, so the result does not
// depend on timing.
template <int HD>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_combine_kernel(const float* __restrict__ m_part,
                     const float* __restrict__ l_part,
                     const float* __restrict__ acc_part,
                     const int* __restrict__ lengths,
                     float* __restrict__ out, int H, int S, int ps, int M,
                     int span) {
  constexpr int kCols = HD / 4;
  constexpr int kGroups = kCombineThreads / kCols;
  constexpr int kWarpsC = kCombineThreads / 32;
  __shared__ float red_s[kWarpsC];
  __shared__ float4 part_s[kGroups * kCols];
  extern __shared__ float w_s[];               // (S,) split weights
  const int b = blockIdx.x;
  const size_t bh = static_cast<size_t>(b) * H + blockIdx.y;
  const int len = min(lengths[b], M * ps);
  const int n = min(S, ((len + ps - 1) / ps + span - 1) / span);
  const float* m = m_part + bh * S;
  const float* l = l_part + bh * S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float mx = -CUDART_INF_F;
  for (int s = threadIdx.x; s < n; s += kCombineThreads)
    mx = fmaxf(mx, m[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
  if (lane == 0) red_s[warp] = mx;
  __syncthreads();
  mx = red_s[0];
#pragma unroll
  for (int w = 1; w < kWarpsC; ++w) mx = fmaxf(mx, red_s[w]);
  __syncthreads();

  float denom = 0.f;
  for (int s = threadIdx.x; s < n; s += kCombineThreads) {
    const float w = exp2f(m[s] - mx);
    w_s[s] = w;
    denom = fmaf(w, l[s], denom);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    denom += __shfl_xor_sync(kFullMask, denom, off);
  if (lane == 0) red_s[warp] = denom;
  __syncthreads();
  denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsC; ++w) denom += red_s[w];

  const int c = threadIdx.x % kCols;
  const int r = threadIdx.x / kCols;
  const float4* acc = reinterpret_cast<const float4*>(acc_part + bh * S * HD)
                      + c;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = r; s < n; s += kGroups) o = fma4(w_s[s], acc[s * kCols], o);
  part_s[r * kCols + c] = o;
  __syncthreads();
  if (r == 0) {
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      const float4 p = part_s[g * kCols + c];
      o = make_float4(o.x + p.x, o.y + p.y, o.z + p.z, o.w + p.w);
    }
    reinterpret_cast<float4*>(out + bh * HD)[c] =
        div4(o, fmaxf(denom, 1e-30f));
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* table, const int* lengths, float* out,
                   float* m_part, float* l_part, float* acc_part, int B,
                   int H, int KV, int P, int ps, int M, int span, int S,
                   float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      (static_cast<size_t>(G) * HD + 2 * kStages * static_cast<size_t>(ps) * HD
       + static_cast<size_t>(G) * ps + 3 * G + span) * sizeof(float);
  auto split_kernel = paged_attention_split_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  split_kernel<<<dim3(B, KV, S), kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, lengths, out, m_part, l_part, acc_part, H,
      KV, P, ps, M, span, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  paged_attention_combine_kernel<HD><<<dim3(B, H), kCombineThreads,
                             S * sizeof(float), stream>>>(
      m_part, l_part, acc_part, lengths, out, H, S, ps, M, span);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd), k_pool/v_pool (P, ps, KV, hd), out (B, H, hd): float32,
// contiguous, 16-byte aligned.  table (B, M), lengths (B,): int32.
// hd in {32, 64, 128, 256}; H % KV == 0 and H / KV <= 32; B, KV and
// S = ceil(M / span) at most 65535.  With S > 1, m_part and l_part
// (B, H, S) and acc_part (B, H, S, hd) are float32 scratch (unused, and
// may be null, with S = 1).  Launches on `stream` of device `device` and
// returns the launches' cudaError_t.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool, const int* table,
                                   const int* lengths, float* out,
                                   float* m_part, float* l_part,
                                   float* acc_part, int B, int H, int KV,
                                   int hd, int P, int ps, int M, int span,
                                   float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (span < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int S = (M + span - 1) / span;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      err = launch<32>(q, k_pool, v_pool, table, lengths, out, m_part,
                       l_part, acc_part, B, H, KV, P, ps, M, span, S, scale,
                       s);
      break;
    case 64:
      err = launch<64>(q, k_pool, v_pool, table, lengths, out, m_part,
                       l_part, acc_part, B, H, KV, P, ps, M, span, S, scale,
                       s);
      break;
    case 128:
      err = launch<128>(q, k_pool, v_pool, table, lengths, out, m_part,
                        l_part, acc_part, B, H, KV, P, ps, M, span, S, scale,
                        s);
      break;
    case 256:
      err = launch<256>(q, k_pool, v_pool, table, lengths, out, m_part,
                        l_part, acc_part, B, H, KV, P, ps, M, span, S, scale,
                        s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
