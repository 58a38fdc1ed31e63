// Flash attention for Hopper (sm_90a): forward, dq and dk/dv kernels.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// tensorflowonspark_tpu/ops/flash_attention.py:
//   flash_fwd      <- _fwd_kernel      (pallas_call in _flash_fwd)
//   flash_bwd_dq   <- _bwd_dq_kernel   (first pallas_call in _flash_bwd)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (second pallas_call in _flash_bwd)
//
// Operands are [BH, L, D] row-major (q, k, v, o, do, dq, dk, dv) in bf16 or
// f32, row statistics (lse, delta) are [BH, L] f32 and segment ids are
// int32 [B, L], read at b = bh / heads (never broadcast over heads).
//
// Bound on an H100 SXM: every kernel is a chain of matrix products over
// 64x64 tiles (QK^T and PV forward; QK^T, dO V^T, dS K for dq; QK^T, dO V^T,
// P^T dO, dS^T Q for dk/dv), 2*L*L*D flops per product and head (halved by
// the causal skip), against O(L*D) bytes: at L=2048, D=64 the operations
// bound them (989 TFLOP/s dense bf16), not the 3.35 TB/s of device memory.
//
// Design (simple first): one CTA of 4 warps per (bh, 64-row block). Q/dO or
// K/V tiles are staged in shared memory, scores and accumulators live in
// shared memory as f32, and bf16 products run on the tensor cores through
// warp-level WMMA (m16n16k16, f32 accumulate). f32 inputs take a plain FMA
// path (no TF32). p and ds are cast to the input dtype before the second
// product, as the TPU kernels do. Every CTA owns its output rows, so sums
// are deterministic (no atomics). Ragged tails are masked: rows past L are
// loaded as zeros and never stored, columns past L score -inf (exactly zero
// weight), so any L works without padding. Masked scores take the finite
// sentinel -0.7 * FLT_MAX of the TPU kernels (not -inf), so a row whose
// first visited block is fully masked accumulates finite garbage that the
// correction exp(sentinel - m_real) = 0 wipes once its diagonal arrives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBlock = 64;     // rows of a q block and of a kv block
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory row strides. Input tiles pad their rows: 8 bf16 (16 bytes,
// WMMA's ldm rule) or 1 f32 (an odd stride, so the FMA path's column walks
// hit 32 distinct banks). f32 scores and accumulators are unpadded.
template <typename T> struct Pad { static constexpr int value = std::is_same<T, bf16>::value ? 8 : 1; };

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }
// one per-row vector of 64 words
constexpr size_t kVecBytes = round128(sizeof(float) * kBlock);

// Shared-memory plan of one CTA: `tiles` input tiles [64][D + pad], `scores`
// f32 [64][64] buffers, `casts` T-typed [64][64 + pad] copies of p / ds
// (none for f32: they overwrite their f32 scores in place), `accs` f32
// [64][D] accumulators and 4 per-row vectors of 64 words.
template <typename T, int D> struct Plan {
  static constexpr int kTileLd = D + Pad<T>::value;
  static constexpr int kCastLd = std::is_same<T, bf16>::value ? kBlock + Pad<T>::value : kBlock;
  static constexpr size_t kTile = round128(sizeof(T) * kBlock * kTileLd);
  static constexpr size_t kScore = round128(sizeof(float) * kBlock * kBlock);
  static constexpr size_t kCast = std::is_same<T, bf16>::value ? round128(sizeof(T) * kBlock * kCastLd) : 0;
  static constexpr size_t kAcc = round128(sizeof(float) * kBlock * D);
  static constexpr size_t kVec = 4 * kVecBytes;
  static constexpr size_t bytes(int tiles, int scores, int casts, int accs) {
    return tiles * kTile + scores * kScore + casts * kCast + accs * kAcc + kVec;
  }
};

// Carves the dynamic shared memory in the order the kernels ask for it.
struct Carver {
  char* p;
  template <typename U> __device__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// Rows [row0, row0 + 64) of a [L, D] matrix into a [64][ld] tile; rows past
// L read as zeros.
template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, int row0, int L) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kVecs = D / 8;  // 16-byte vectors a row
    for (int i = threadIdx.x; i < kBlock * kVecs; i += kThreads) {
      int r = i / kVecs, c = (i % kVecs) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row0 + r < L) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
      int r = i / D, c = i % D;
      dst[r * ld + c] = row0 + r < L ? src[(size_t)(row0 + r) * D + c] : 0.0f;
    }
  }
}

// 64 entries of a per-row vector from `src` (length L) at row0; `fill` past L.
template <typename U>
__device__ void load_vec(U* dst, const U* src, int row0, int L, U fill) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) dst[i] = row0 + i < L ? src[row0 + i] : fill;
}

// C[64][N] (+)= A[64][K] . B[K][N] over shared memory. A(i, k) is
// A[k * lda + i] when A_COL (A stored transposed) else A[i * lda + k];
// B(k, j) is B[j * ldb + k] when B_COL else B[k * ldb + j].
template <typename T, int N, int K, bool A_COL, bool B_COL, bool ACCUM>
__device__ void tile_mm(const T* A, int lda, const T* B, int ldb, float* C, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    // tensor cores: warp w owns output rows [16w, 16w + 16), all N columns
    namespace wmma = nvcuda::wmma;
    using LA = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
    const int i0 = (threadIdx.x / 32) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      if (ACCUM) wmma::load_matrix_sync(acc[n], C + i0 * ldc + n * 16, ldc, wmma::mem_row_major);
      else wmma::fill_fragment(acc[n], 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::load_matrix_sync(a, A_COL ? A + kk * 16 * lda + i0 : A + i0 * lda + kk * 16, lda);
#pragma unroll
      for (int n = 0; n < N / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(b, B_COL ? B + n * 16 * ldb + kk * 16 : B + kk * 16 * ldb + n * 16, ldb);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < N / 16; ++n)
      wmma::store_matrix_sync(C + i0 * ldc + n * 16, acc[n], ldc, wmma::mem_row_major);
  } else {
    // f32 FMA: thread t owns column j = t % N of rows g, g + G, g + 2G, ...
    // (G = 128 / N row groups, g = t / N); a warp shares its rows, so A
    // reads broadcast and B reads walk distinct banks
    constexpr int G = kThreads / N;
    constexpr int R = kBlock / G;
    const int j = threadIdx.x % N, g = threadIdx.x / N;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = ACCUM ? C[(g + r * G) * ldc + j] : 0.0f;
    for (int k = 0; k < K; ++k) {
      const float b = B_COL ? B[j * ldb + k] : B[k * ldb + j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + r * G;
        acc[r] = fmaf(A_COL ? A[k * lda + i] : A[i * lda + k], b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) C[(g + r * G) * ldc + j] = acc[r];
  }
}

// The masked, scaled score of (query qi, key kj): -inf past L (no weight at
// all), the sentinel where the causal mask or the segment fence drops it.
__device__ __forceinline__ float masked_score(float s, float scale, int qi, int kj, int L, bool causal,
                                              bool segmented, int seg_q, int seg_k) {
  if (kj >= L) return -INFINITY;
  s *= scale;
  if (causal && kj > qi) s = kNegBig;
  if (segmented && seg_q != seg_k) s = kNegBig;
  return s;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
                 int L, int heads, float scale, bool causal) {
  using P = Plan<T, D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(P::kTile);
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  T* ps = std::is_same<T, bf16>::value ? cv.take<T>(P::kCast) : reinterpret_cast<T*>(s);
  float* acc = cv.take<float>(P::kAcc);
  float* m_row = cv.take<float>(kVecBytes);
  float* l_row = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, D>(qs, P::kTileLd, q + base, q0, L);
  if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) { m_row[i] = kNegBig; l_row[i] = 0.0f; }

  const int n_kv = (L + kBlock - 1) / kBlock;
  // causal: kv blocks strictly above the diagonal contribute nothing
  const int kv_end = causal ? min(n_kv, (int)blockIdx.y + 1) : n_kv;
  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous block is done with ks / vs / ps
    load_tile<T, D>(ks, P::kTileLd, k + base, k0, L);
    load_tile<T, D>(vs, P::kTileLd, v + base, k0, L);
    if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
    __syncthreads();
    tile_mm<T, kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
    __syncthreads();
    // online softmax: warp w folds rows [16w, 16w + 16), lanes 2 columns each
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int qi = q0 + r;
      float x0 = masked_score(s[r * kBlock + lane], scale, qi, k0 + lane, L, causal, seg_b, seg_q[r], seg_k[lane]);
      float x1 = masked_score(s[r * kBlock + lane + 32], scale, qi, k0 + lane + 32, L, causal, seg_b, seg_q[r],
                              seg_k[lane + 32]);
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float corr = expf(m_old - m_new);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float row_sum = warp_sum(p0 + p1);
      __syncwarp();  // every lane has read its scores before ps (maybe s) is written
      ps[r * P::kCastLd + lane] = from_f<T>(p0);
      ps[r * P::kCastLd + lane + 32] = from_f<T>(p1);
      for (int c = lane; c < D; c += 32) acc[r * D + c] *= corr;
      if (lane == 0) {
        l_row[r] = l_row[r] * corr + row_sum;
        m_row[r] = m_new;
      }
    }
    __syncthreads();
    tile_mm<T, D, kBlock, false, false, true>(ps, P::kCastLd, vs, P::kTileLd, acc, D);
  }
  __syncthreads();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= L) break;
    const float denom = fmaxf(l_row[r], 1e-30f);
    for (int c = lane; c < D; c += 32) o[base + (size_t)qi * D + c] = from_f<T>(acc[r * D + c] / denom);
    if (lane == 0) lse[(size_t)bh * L + qi] = m_row[r] + logf(denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int L, int heads, float scale,
                    bool causal) {
  using P = Plan<T, D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(P::kTile);
  T* dos = cv.take<T>(P::kTile);
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  float* dp = cv.take<float>(P::kScore);
  T* dss = std::is_same<T, bf16>::value ? cv.take<T>(P::kCast) : reinterpret_cast<T*>(s);
  float* acc = cv.take<float>(P::kAcc);
  float* lse_r = cv.take<float>(kVecBytes);
  float* delta_r = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  load_tile<T, D>(qs, P::kTileLd, q + base, q0, L);
  load_tile<T, D>(dos, P::kTileLd, dout + base, q0, L);
  load_vec(lse_r, lse + (size_t)bh * L, q0, L, 0.0f);
  load_vec(delta_r, delta + (size_t)bh * L, q0, L, 0.0f);
  if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) acc[i] = 0.0f;

  const int n_kv = (L + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, (int)blockIdx.y + 1) : n_kv;
  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T, D>(ks, P::kTileLd, k + base, k0, L);
    load_tile<T, D>(vs, P::kTileLd, v + base, k0, L);
    if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
    __syncthreads();
    tile_mm<T, kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
    tile_mm<T, kBlock, D, false, true, false>(dos, P::kTileLd, vs, P::kTileLd, dp, kBlock);
    __syncthreads();
    // ds = p * (dp - delta) * scale, p recomputed from the saved lse; each
    // thread reads then overwrites its own entries (f32: ds lands on s)
    for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
      const int r = i / kBlock, c = i % kBlock;
      const float x = masked_score(s[i], scale, q0 + r, k0 + c, L, causal, seg_b, seg_q[r], seg_k[c]);
      const float p = expf(x - lse_r[r]);
      dss[r * P::kCastLd + c] = from_f<T>(p * (dp[i] - delta_r[r]) * scale);
    }
    __syncthreads();
    tile_mm<T, D, kBlock, false, false, true>(dss, P::kCastLd, ks, P::kTileLd, acc, D);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < L) dq[base + (size_t)(q0 + r) * D + c] = from_f<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int heads,
                     float scale, bool causal) {
  using P = Plan<T, D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  T* qs = cv.take<T>(P::kTile);
  T* dos = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  float* dp = cv.take<float>(P::kScore);
  const bool cast = std::is_same<T, bf16>::value;
  T* ps = cast ? cv.take<T>(P::kCast) : reinterpret_cast<T*>(s);
  T* dss = cast ? cv.take<T>(P::kCast) : reinterpret_cast<T*>(dp);
  float* dk_acc = cv.take<float>(P::kAcc);
  float* dv_acc = cv.take<float>(P::kAcc);
  float* lse_r = cv.take<float>(kVecBytes);
  float* delta_r = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, k0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  load_tile<T, D>(ks, P::kTileLd, k + base, k0, L);
  load_tile<T, D>(vs, P::kTileLd, v + base, k0, L);
  if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) dk_acc[i] = dv_acc[i] = 0.0f;

  const int n_q = (L + kBlock - 1) / kBlock;
  // causal: q blocks strictly above this kv block contribute nothing
  const int q_begin = causal ? (int)blockIdx.y : 0;
  for (int qb = q_begin; qb < n_q; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
    load_tile<T, D>(qs, P::kTileLd, q + base, q0, L);
    load_tile<T, D>(dos, P::kTileLd, dout + base, q0, L);
    load_vec(lse_r, lse + (size_t)bh * L, q0, L, 0.0f);
    load_vec(delta_r, delta + (size_t)bh * L, q0, L, 0.0f);
    if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
    __syncthreads();
    tile_mm<T, kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
    tile_mm<T, kBlock, D, false, true, false>(dos, P::kTileLd, vs, P::kTileLd, dp, kBlock);
    __syncthreads();
    // rows are queries, columns keys; queries past L carry no weight
    for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
      const int r = i / kBlock, c = i % kBlock;
      const float x = masked_score(s[i], scale, q0 + r, k0 + c, L, causal, seg_b, seg_q[r], seg_k[c]);
      const float p = q0 + r < L ? expf(x - lse_r[r]) : 0.0f;
      const float ds = p * (dp[i] - delta_r[r]) * scale;
      ps[r * P::kCastLd + c] = from_f<T>(p);
      dss[r * P::kCastLd + c] = from_f<T>(ds);
    }
    __syncthreads();
    tile_mm<T, D, kBlock, true, false, true>(ps, P::kCastLd, dos, P::kTileLd, dv_acc, D);
    tile_mm<T, D, kBlock, true, false, true>(dss, P::kCastLd, qs, P::kTileLd, dk_acc, D);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < L) {
      dk[base + (size_t)(k0 + r) * D + c] = from_f<T>(dk_acc[i]);
      dv[base + (size_t)(k0 + r) * D + c] = from_f<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int bh, int heads,
               int L, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Plan<T, D>::bytes(3, 1, 1, 1);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), seg, static_cast<T*>(o), lse, L, heads, scale,
                                         causal != 0);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const int* seg, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int heads, int L, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Plan<T, D>::bytes(4, 2, 1, 1);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
                                         static_cast<T*>(dq), L, heads, scale, causal != 0);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const int* seg, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int heads, int L, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = Plan<T, D>::bytes(4, 2, 2, 2);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
                                         static_cast<T*>(dk), static_cast<T*>(dv), L, heads, scale, causal != 0);
  return (int)cudaGetLastError();
}

// Unsupported head dim or dtype: the wrapper checks first, so this is a guard.
constexpr int kUnsupported = -1;

}  // namespace

// C interface for ctypes. dtype: 0 = float32, 1 = bfloat16; seg may be null
// (no fence); returns 0 or a cudaError_t code (kUnsupported for a bad D/dtype).
extern "C" {

int tos_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int bh,
                  int heads, int L, int D, int dtype, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_fwd<bf16, 64>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128) return launch_fwd<bf16, 128>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 64) return launch_fwd<float, 64>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 128) return launch_fwd<float, 128>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  return kUnsupported;
}

int tos_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg, const void* dout,
                     const float* lse, const float* delta, void* dq, int bh, int heads, int L, int D, int dtype,
                     float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_dq<bf16, 64>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dq<bf16, 128>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
  return kUnsupported;
}

int tos_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg, const void* dout,
                      const float* lse, const float* delta, void* dk, void* dv, int bh, int heads, int L, int D,
                      int dtype, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_dkv<bf16, 64>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dkv<bf16, 128>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  return kUnsupported;
}

}  // extern "C"
