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
// 64x64 tiles (QK^T and PV forward; QK^T, dO V^T, dS K for dq; KQ^T, V dO^T,
// P^T dO, dS^T Q for dk/dv), 2*D flops per product and attended (q, k) pair,
// against O(L*D) bytes: the operations bound them on the work the causal
// mask leaves (989 TFLOP/s dense bf16); with the packed-sequence fence most
// of that work is masked, and the bytes (3.35 TB/s) bound the data's own
// work.
//
// float32 (simple first): one CTA of 4 warps per (bh, 64-row block). Q/dO
// or K/V tiles are staged in shared memory, scores and accumulators live in
// shared memory as f32, and the products take a plain FMA path (no TF32).
//
// bf16 (the Hopper design, forward and backward): one warpgroup a CTA,
// `wgmma` products (m64n64k16, f32 accumulators in registers), operands fed
// by TMA into 128-byte-swizzled shared tiles through an mbarrier ring of 2-3
// stages, so the next block's tiles are in flight while the tensor cores
// work on this one. No score or accumulator tile touches shared memory:
//   forward: Q resident; the ring carries (K, V). S = Q K^T reads both
//          operands from shared memory; the online softmax runs in the
//          accumulators' registers in the log2 domain (the four lanes of a
//          quad hold a row: max by two shuffles, the running sum kept per
//          lane and reduced once at the end), and P, rounded to bf16, is
//          already the A operand layout of O += P V (B = V, transposed
//          descriptor).
//   dq:    Q, dO resident; the ring carries (K, V). S = Q K^T and
//          dP = dO V^T read both operands from shared memory; dS is formed
//          in the accumulators' registers, which are already the A operand
//          layout of dQ += dS K (B = K, transposed descriptor).
//   dk/dv: K, V resident; the ring carries (Q, dO). Scores are computed
//          transposed, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//          out in the A operand layout of dV += P^T dO and dK += dS^T Q.
// The bf16 kernels never visit a block pair that the causal mask or the
// segment fence empties (visit_list: a block pair is skipped when the
// [min, max] segment-id ranges of its two blocks do not overlap, which is
// exact for any ids).
//
// Common to every kernel: p and ds are cast to the input dtype before the
// second product, as the TPU kernels do. Every CTA owns its output rows, so
// sums are deterministic (no atomics). Ragged tails are masked: rows past L
// are loaded as zeros and never stored, columns past L get exactly zero
// weight, so any L works without padding. Masked scores take the finite
// sentinel -0.7 * FLT_MAX of the TPU kernels (not -inf), so a row whose
// first visited block is fully masked accumulates finite garbage that the
// correction exp(sentinel - m_real) = 0 wipes once its diagonal arrives.
// The bf16 forward keeps its scores in the log2 domain (exp2): it sets the
// sentinel after scaling (sentinel * log2 e would overflow to -inf) and
// starts each row's max at it, so the max never reaches -inf and the
// correction exp2(m_old - m_new) is never -inf - -inf = NaN.
//
// Host side of a launch, and CUDA graph capture: the wrappers launch on the
// caller's stream and allocate nothing. A kernel's dynamic shared memory
// limit is raised once per device and size (allow_smem), so a launch after
// the first, inside a capture or not, makes no cudaFuncSetAttribute call.
// The bf16 kernels' TMA tensor maps are encoded on the host for each launch
// by the CUDA driver's cuTensorMapEncodeTiled, a host-only function of the
// operands' addresses and shapes, and travel as __grid_constant__ kernel
// parameters: a captured launch keeps them by value, and replays reuse the
// same addresses.

#include <cuda.h>  // CUtensorMap (types only: the encoder comes from the runtime's entry point)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxDevices = 64;

// Raises Kern's dynamic shared memory limit to smem on the current device
// the first time a launch needs that much (the attribute persists, so later
// launches, and launches under stream capture, skip the call).
template <auto Kern>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<size_t> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (allowed[dev].load() >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed[dev].store(smem);
  return err;
}

constexpr int kBlock = 64;     // rows of a q block and of a kv block
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }
// one per-row vector of 64 words
constexpr size_t kVecBytes = round128(sizeof(float) * kBlock);

// Shared-memory plan of one CTA of the float32 kernels: `tiles` input
// tiles [64][D + 1] (an odd row stride, so the FMA path's column walks hit
// 32 distinct banks), `scores` f32 [64][64] buffers (p and ds overwrite
// their scores in place), `accs` f32 [64][D] accumulators and 4 per-row
// vectors of 64 words.
template <int D> struct Plan {
  static constexpr int kTileLd = D + 1;
  static constexpr size_t kTile = round128(sizeof(float) * kBlock * kTileLd);
  static constexpr size_t kScore = round128(sizeof(float) * kBlock * kBlock);
  static constexpr size_t kAcc = round128(sizeof(float) * kBlock * D);
  static constexpr size_t kVec = 4 * kVecBytes;
  static constexpr size_t bytes(int tiles, int scores, int accs) {
    return tiles * kTile + scores * kScore + accs * kAcc + kVec;
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
template <int D>
__device__ void load_tile(float* dst, int ld, const float* src, int row0, int L) {
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    int r = i / D, c = i % D;
    dst[r * ld + c] = row0 + r < L ? src[(size_t)(row0 + r) * D + c] : 0.0f;
  }
}

// 64 entries of a per-row vector from `src` (length L) at row0; `fill` past L.
template <typename U>
__device__ void load_vec(U* dst, const U* src, int row0, int L, U fill) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) dst[i] = row0 + i < L ? src[row0 + i] : fill;
}

// C[64][N] (+)= A[64][K] . B[K][N] over shared memory, f32 FMA. A(i, k) is
// A[k * lda + i] when A_COL (A stored transposed) else A[i * lda + k];
// B(k, j) is B[j * ldb + k] when B_COL else B[k * ldb + j]. Thread t owns
// column j = t % N of rows g, g + G, g + 2G, ... (G = 128 / N row groups,
// g = t / N); a warp shares its rows, so A reads broadcast and B reads walk
// distinct banks.
template <int N, int K, bool A_COL, bool B_COL, bool ACCUM>
__device__ void tile_mm(const float* A, int lda, const float* B, int ldb, float* C, int ldc) {
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

// float32 forward (FMA, never TF32): bf16 takes flash_fwd_wgmma_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, T* __restrict__ o, float* __restrict__ lse,
                 int L, int heads, float scale, bool causal) {
  static_assert(std::is_same<T, float>::value, "bf16 takes flash_fwd_wgmma_kernel");
  using P = Plan<D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(P::kTile);
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  float* ps = s;  // p overwrites its scores in place
  float* acc = cv.take<float>(P::kAcc);
  float* m_row = cv.take<float>(kVecBytes);
  float* l_row = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(qs, P::kTileLd, q + base, q0, L);
  if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < kBlock; i += kThreads) { m_row[i] = kNegBig; l_row[i] = 0.0f; }

  const int n_kv = (L + kBlock - 1) / kBlock;
  // causal: kv blocks strictly above the diagonal contribute nothing
  const int kv_end = causal ? min(n_kv, (int)blockIdx.y + 1) : n_kv;
  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous block is done with ks / vs / ps
    load_tile<D>(ks, P::kTileLd, k + base, k0, L);
    load_tile<D>(vs, P::kTileLd, v + base, k0, L);
    if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
    __syncthreads();
    tile_mm<kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
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
      __syncwarp();  // every lane has read its scores before ps (= s) is written
      ps[r * kBlock + lane] = p0;
      ps[r * kBlock + lane + 32] = p1;
      for (int c = lane; c < D; c += 32) acc[r * D + c] *= corr;
      if (lane == 0) {
        l_row[r] = l_row[r] * corr + row_sum;
        m_row[r] = m_new;
      }
    }
    __syncthreads();
    tile_mm<D, kBlock, false, false, true>(ps, kBlock, vs, P::kTileLd, acc, D);
  }
  __syncthreads();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= L) break;
    const float denom = fmaxf(l_row[r], 1e-30f);
    for (int c = lane; c < D; c += 32) o[base + (size_t)qi * D + c] = acc[r * D + c] / denom;
    if (lane == 0) lse[(size_t)bh * L + qi] = m_row[r] + logf(denom);
  }
}

// float32 backward (FMA, never TF32): bf16 takes the wgmma kernels below.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int L, int heads, float scale,
                    bool causal) {
  static_assert(std::is_same<T, float>::value, "bf16 takes flash_bwd_dq_wgmma_kernel");
  using P = Plan<D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* qs = cv.take<T>(P::kTile);
  T* dos = cv.take<T>(P::kTile);
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  float* dp = cv.take<float>(P::kScore);
  T* dss = s;  // ds overwrites its scores in place
  float* acc = cv.take<float>(P::kAcc);
  float* lse_r = cv.take<float>(kVecBytes);
  float* delta_r = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, q0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  load_tile<D>(qs, P::kTileLd, q + base, q0, L);
  load_tile<D>(dos, P::kTileLd, dout + base, q0, L);
  load_vec(lse_r, lse + (size_t)bh * L, q0, L, 0.0f);
  load_vec(delta_r, delta + (size_t)bh * L, q0, L, 0.0f);
  if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) acc[i] = 0.0f;

  const int n_kv = (L + kBlock - 1) / kBlock;
  const int kv_end = causal ? min(n_kv, (int)blockIdx.y + 1) : n_kv;
  for (int kb = 0; kb < kv_end; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<D>(ks, P::kTileLd, k + base, k0, L);
    load_tile<D>(vs, P::kTileLd, v + base, k0, L);
    if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
    __syncthreads();
    tile_mm<kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
    tile_mm<kBlock, D, false, true, false>(dos, P::kTileLd, vs, P::kTileLd, dp, kBlock);
    __syncthreads();
    // ds = p * (dp - delta) * scale, p recomputed from the saved lse; each
    // thread reads then overwrites its own entries
    for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
      const int r = i / kBlock, c = i % kBlock;
      const float x = masked_score(s[i], scale, q0 + r, k0 + c, L, causal, seg_b, seg_q[r], seg_k[c]);
      const float p = expf(x - lse_r[r]);
      dss[r * kBlock + c] = p * (dp[i] - delta_r[r]) * scale;
    }
    __syncthreads();
    tile_mm<D, kBlock, false, false, true>(dss, kBlock, ks, P::kTileLd, acc, D);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < L) dq[base + (size_t)(q0 + r) * D + c] = acc[i];
  }
}

// float32 backward (FMA, never TF32): bf16 takes the wgmma kernels below.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int L, int heads,
                     float scale, bool causal) {
  static_assert(std::is_same<T, float>::value, "bf16 takes flash_bwd_dkv_wgmma_kernel");
  using P = Plan<D>;
  extern __shared__ __align__(128) char smem[];
  Carver cv{smem};
  T* ks = cv.take<T>(P::kTile);
  T* vs = cv.take<T>(P::kTile);
  T* qs = cv.take<T>(P::kTile);
  T* dos = cv.take<T>(P::kTile);
  float* s = cv.take<float>(P::kScore);
  float* dp = cv.take<float>(P::kScore);
  T* ps = s;  // p and ds overwrite their scores in place
  T* dss = dp;
  float* dk_acc = cv.take<float>(P::kAcc);
  float* dv_acc = cv.take<float>(P::kAcc);
  float* lse_r = cv.take<float>(kVecBytes);
  float* delta_r = cv.take<float>(kVecBytes);
  int* seg_q = cv.take<int>(kVecBytes);
  int* seg_k = cv.take<int>(kVecBytes);

  const int bh = blockIdx.x, k0 = blockIdx.y * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  load_tile<D>(ks, P::kTileLd, k + base, k0, L);
  load_tile<D>(vs, P::kTileLd, v + base, k0, L);
  if (seg_b) load_vec(seg_k, seg_b, k0, L, -1);
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) dk_acc[i] = dv_acc[i] = 0.0f;

  const int n_q = (L + kBlock - 1) / kBlock;
  // causal: q blocks strictly above this kv block contribute nothing
  const int q_begin = causal ? (int)blockIdx.y : 0;
  for (int qb = q_begin; qb < n_q; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
    load_tile<D>(qs, P::kTileLd, q + base, q0, L);
    load_tile<D>(dos, P::kTileLd, dout + base, q0, L);
    load_vec(lse_r, lse + (size_t)bh * L, q0, L, 0.0f);
    load_vec(delta_r, delta + (size_t)bh * L, q0, L, 0.0f);
    if (seg_b) load_vec(seg_q, seg_b, q0, L, -1);
    __syncthreads();
    tile_mm<kBlock, D, false, true, false>(qs, P::kTileLd, ks, P::kTileLd, s, kBlock);
    tile_mm<kBlock, D, false, true, false>(dos, P::kTileLd, vs, P::kTileLd, dp, kBlock);
    __syncthreads();
    // rows are queries, columns keys; queries past L carry no weight
    for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
      const int r = i / kBlock, c = i % kBlock;
      const float x = masked_score(s[i], scale, q0 + r, k0 + c, L, causal, seg_b, seg_q[r], seg_k[c]);
      const float p = q0 + r < L ? expf(x - lse_r[r]) : 0.0f;
      const float ds = p * (dp[i] - delta_r[r]) * scale;
      ps[r * kBlock + c] = p;
      dss[r * kBlock + c] = ds;
    }
    __syncthreads();
    tile_mm<D, kBlock, true, false, true>(ps, kBlock, dos, P::kTileLd, dv_acc, D);
    tile_mm<D, kBlock, true, false, true>(dss, kBlock, qs, P::kTileLd, dk_acc, D);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (k0 + r < L) {
      dk[base + (size_t)(k0 + r) * D + c] = dk_acc[i];
      dv[base + (size_t)(k0 + r) * D + c] = dv_acc[i];
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int bh, int heads,
               int L, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Plan<D>::bytes(3, 1, 1);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem<flash_fwd_kernel<T, D>>(smem);
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
  const size_t smem = Plan<D>::bytes(4, 2, 1);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem<flash_bwd_dq_kernel<T, D>>(smem);
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
  const size_t smem = Plan<D>::bytes(4, 2, 2);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem<flash_bwd_dkv_kernel<T, D>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (L + kBlock - 1) / kBlock);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), seg, static_cast<const T*>(dout), lse, delta,
                                         static_cast<T*>(dk), static_cast<T*>(dv), L, heads, scale, causal != 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 kernels for Hopper: wgmma + TMA + mbarrier ring (see the header).

constexpr int kPanelBytes = kBlock * 64 * 2;  // a 64-row x 64-column bf16 panel: 128-byte rows
constexpr int kSwizzleAtom = 1024;            // 8 rows of 128 bytes: one 128-byte-swizzle atom
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A 64 x 64 bf16 box of a [BH, L, D] tensor map (column c0, row c1, head
// c2) into a 1024-byte-aligned panel, 128-byte swizzled; rows past L land
// as zeros. Completes its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Pins registers that a wgmma reads or writes at a point of the program
// order (before the fence, after the wait), so the compiler neither moves
// their definitions past the fence nor reuses or reads them while the
// asynchronous product owns them.
template <int N> __device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// wgmma shared-memory descriptors of 128-byte-swizzled operands (layout
// type 1 in bits 62-63, byte offsets in 16-byte units). K-major (K along
// the 128-byte rows): 8-row M/N groups one atom apart (stride byte offset);
// the leading byte offset is implied by the swizzle and set to 1.
// MN-major (MN along the rows, K down them): 8-row K groups one atom apart.
// Each product here spans a single 64-element column of atoms, so the
// offset to the next column is never taken: both offsets are one atom.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint64_t lbo, uint64_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) { return sw128_desc(p, 1, kSwizzleAtom >> 4); }
__device__ __forceinline__ uint64_t mnmajor_desc(const void* p) {
  return sw128_desc(p, kSwizzleAtom >> 4, kSwizzleAtom >> 4);
}

#define TOS_ACC32                                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),       \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),        \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),        \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define TOS_D32                                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] . B[16 x 64], both from shared memory, both
// K-major; d in the warpgroup's accumulator layout, f32.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TOS_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TOS_ACC32
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (bf16 pairs in the
// accumulator layout), B from shared memory MN-major (its rows are K).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TOS_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TOS_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TOS_ACC32
#undef TOS_D32

// Round-to-nearest bf16 pair, the low half first (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element i of a thread (lane, warp w of the warpgroup) sits at
// row 16 w + lane / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (lane % 4)
// + i % 2. Elements 8c .. 8c + 7 are then, as bf16 pairs, exactly the A
// fragment of columns 16c .. 16c + 15 for a product from registers.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1); }

// d[64 x 64] += A . B^T over a D-wide contraction: A and B are [64][D]
// tiles of D / 64 swizzled panels each (K-major), 16 columns a step.
template <int D>
__device__ __forceinline__ void tile_abt(float (&d)[32], const char* a, const char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss(d, kmajor_desc(a + off), kmajor_desc(b + off));
  }
}

// acc[64 x D] += frag[64 x 64] . B[64 x D]: the fragments hold the 64-wide
// contraction in 4 steps of 16; B is a [64][D] tile whose rows are the
// contraction (MN-major), one n64 product per panel.
template <int D>
__device__ __forceinline__ void tile_fb(float (&acc)[D / 64][32], const uint32_t (&frag)[4][4], const char* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn)
      wgmma_rs(acc[pn], frag[c], mnmajor_desc(b + pn * kPanelBytes + c * 16 * 128));
}

// The fence-aware block skip: which of the candidate blocks [lo, hi) a CTA
// visits, given its own block at rows [own0, own0 + 64). Without segment
// ids every candidate is visited; with them, a candidate whose [min, max]
// id range does not overlap the own block's holds no pair of equal ids,
// so every score between the two is masked (p = 0 exactly) and the pair is
// skipped. Ids past L are ignored. Writes the visited block indices, in
// order, to list[] and returns their count. flags[] (hi - lo words) and
// scratch[1] are shared memory; every thread of the CTA must call it.
__device__ int visit_list(const int* seg_b, int L, int own0, int lo, int hi, int* flags, int* list, int* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32, n = hi - lo;
  if (seg_b) {
    // a warp takes a block's 64 ids as 2 a lane; min and max over those < L
    auto range = [&](int row0, const int (&v)[2], int& mn, int& mx) {
      const bool a = row0 + lane < L, b = row0 + 32 + lane < L;
      mn = __reduce_min_sync(0xffffffffu, min(a ? v[0] : INT_MAX, b ? v[1] : INT_MAX));
      mx = __reduce_max_sync(0xffffffffu, max(a ? v[0] : INT_MIN, b ? v[1] : INT_MIN));
    };
    auto load = [&](int row0, int (&v)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) v[h] = row0 + 32 * h + lane < L ? seg_b[row0 + 32 * h + lane] : 0;
    };
    // every warp reads the own block's range itself (no barrier), and its
    // candidates kBatch at a time with all their loads in flight together
    constexpr int kBatch = 8;
    int own[2], own_mn, own_mx;
    load(own0, own);
    range(own0, own, own_mn, own_mx);
    for (int i0 = warp; i0 < n; i0 += warps * kBatch) {
      int v[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u * warps < n) load((lo + i0 + u * warps) * kBlock, v[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * warps;
        if (i >= n) break;  // the same for the whole warp
        int mn, mx;
        range((lo + i) * kBlock, v[u], mn, mx);
        if (lane == 0) flags[i] = !(mx < own_mn || mn > own_mx);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) flags[i] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const bool f = base + lane < n && flags[base + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) list[count + __popc(m & ((1u << lane) - 1))] = lo + base + lane;
      count += __popc(m);
    }
    if (lane == 0) scratch[0] = count;
  }
  __syncthreads();
  return scratch[0];
}

// Shared-memory plan of a bf16 CTA (offsets from a 1024-byte-aligned
// base): RESIDENT resident [64][D] tiles (Q in the forward; Q, dO or K, V in
// the backward), a ring of STAGES pairs of tiles, a ring of STAGES row
// vectors (RowVec: the forward uses only the ids), 1 + STAGES mbarriers, a
// scratch word, then flags[] and list[] of n_blk words each.
struct RowVec {
  float lse2[kBlock];  // lse * log2 e
  float delta[kBlock];
  int seg[kBlock];
};

template <int D, int STAGES, int RESIDENT> struct RingPlan {
  static constexpr int kTile = (D / 64) * kPanelBytes;
  static constexpr int kRing = RESIDENT * kTile;
  static constexpr int kVec = kRing + STAGES * 2 * kTile;
  static constexpr int kBars = kVec + STAGES * (int)sizeof(RowVec);
  static constexpr int kScratch = kBars + (1 + STAGES) * 8;
  static constexpr int kList = kScratch + 16;
  static size_t bytes(int n_blk) { return kSwizzleAtom + kList + 2 * (size_t)n_blk * 4; }
};

__device__ __forceinline__ char* align_atom(char* p) {
  return p + ((kSwizzleAtom - (smem_u32(p) & (kSwizzleAtom - 1))) & (kSwizzleAtom - 1));
}

// Starts the loads of one [64][D] tile (rows row0 .., head bh) on `bar`.
template <int D>
__device__ __forceinline__ void load_tile_tma(char* dst, const CUtensorMap* map, uint64_t* bar, int row0, int bh) {
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn) tma_load(dst + pn * kPanelBytes, map, bar, pn * 64, row0, bh);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
                       bf16* __restrict__ o, float* __restrict__ lse, int L, int heads, float scale, bool causal) {
  using R = RingPlan<D, STAGES, 1>;
  extern __shared__ char smem_raw[];
  char* smem = align_atom(smem_raw);
  char* qs = smem;
  RowVec* vec = reinterpret_cast<RowVec*>(smem + R::kVec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + R::kBars);  // [0] resident, [1 + s] ring stage s
  int* scratch = reinterpret_cast<int*>(smem + R::kScratch);
  const int n_blk = (L + kBlock - 1) / kBlock;
  int* flags = reinterpret_cast<int*>(smem + R::kList);
  int* list = flags + n_blk;
  auto ks = [&](int s) { return smem + R::kRing + s * 2 * R::kTile; };
  auto vs = [&](int s) { return smem + R::kRing + s * 2 * R::kTile + R::kTile; };

  // the causal work of a q block grows with its index: the heaviest first
  const int bh = blockIdx.x, qb = n_blk - 1 - (int)blockIdx.y, q0 = qb * kBlock;
  const int tid = threadIdx.x;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  init_barriers(bars, 1 + STAGES);
  if (tid == 0) {
    mbar_expect_tx(&bars[0], R::kTile);
    load_tile_tma<D>(qs, &tm_q, &bars[0], q0, bh);
  }
  // this thread's two q rows and their ids
  int qi[2], seg_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + acc_row(2 * h);
    seg_q[h] = seg_b && qi[h] < L ? seg_b[qi[h]] : 0;
  }
  const float scale2 = scale * kLog2e;
  const int n_vis = visit_list(seg_b, L, q0, 0, causal ? qb + 1 : n_blk, flags, list, scratch);

  // ring stage s takes kv block kb: K, V by TMA, the keys' ids by the
  // threads, read into a register (fetch) well before they are stored
  auto fetch = [&](int kb) {
    const int j = kb * kBlock + tid;
    return seg_b && tid < kBlock && j < L ? seg_b[j] : -1;
  };
  auto issue = [&](int s, int kb, int ids) {
    if (tid == 0) {
      mbar_expect_tx(&bars[1 + s], 2 * R::kTile);
      load_tile_tma<D>(ks(s), &tm_k, &bars[1 + s], kb * kBlock, bh);
      load_tile_tma<D>(vs(s), &tm_v, &bars[1 + s], kb * kBlock, bh);
    }
    if (tid < kBlock) vec[s].seg[tid] = ids;
  };
  {
    int ids[STAGES];
#pragma unroll
    for (int i = 0; i < STAGES; ++i) ids[i] = i < n_vis ? fetch(list[i]) : -1;
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
      if (i < n_vis) issue(i, list[i], ids[i]);
  }
  __syncthreads();  // the ring's ids are in shared memory
  mbar_wait(&bars[0], 0);

  // O's accumulator; each row's running max m (log2 domain, from the
  // sentinel) and this lane's share of its running sum l (the quad's four
  // shares take the same corrections and are added at the end)
  float acc[D / 64][32], m[2] = {kNegBig, kNegBig}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.0f;

  for (int it = 0; it < n_vis; ++it) {
    const int s = it % STAGES, k0 = list[it] * kBlock;
    const bool refill = it + STAGES < n_vis;
    const int ahead = refill ? fetch(list[it + STAGES]) : -1;
    mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    pin(sc);
    wg_fence();
    tile_abt<D>(sc, qs, ks(s));  // S = Q K^T
    wg_commit();
    wg_wait_all();
    pin(sc);
    // scores in the log2 domain, masked after scaling: the sentinel where
    // the causal mask or the fence drops a key, -inf past L; then each
    // row's new max over its quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, c = acc_col(i);  // c is even: this pair is columns c, c + 1
      const int2 sk = seg_b ? *reinterpret_cast<const int2*>(&vec[s].seg[c]) : make_int2(0, 0);
      const int sv[2] = {sk.x, sk.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + c + e;
        float x = sc[i + e] * scale2;
        if ((causal && kj > qi[h]) || (seg_b && sv[e] != seg_q[h])) x = kNegBig;
        if (kj >= L) x = -INFINITY;
        sc[i + e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
    // the previous O += P V has completed (waited below), so acc is ours
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[pn][i] *= corr[(i >> 1) & 1];
    // p = exp2(x - m): summed in f32, packed as bf16 into the A fragments
    // of O += P V
    uint32_t frag[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - m[h]), p1 = exp2f(sc[i + 1] - m[h]);
      l[h] += p0 + p1;
      frag[i >> 3][(i & 7) >> 1] = pack_bf16(p0, p1);
    }
    pin(frag);
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) pin(acc[pn]);
    wg_fence();
    tile_fb<D>(acc, frag, vs(s));  // O += P V
    wg_commit();
    wg_wait_all();
    pin(frag);
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) pin(acc[pn]);
    __syncthreads();  // every thread is done with stage s
    if (refill) issue(s, list[it + STAGES], ahead);
  }

  // O = acc / max(l, 1e-30); lse = m + log(denominator) in natural-log units
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    den[h] = fmaxf(l[h], 1e-30f);
  }
  const size_t base = (size_t)bh * L * D;
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, r = q0 + acc_row(i);
      if (r < L)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)r * D + pn * 64 + acc_col(i)) =
            pack_bf16(acc[pn][i] / den[h], acc[pn][i + 1] / den[h]);
    }
  if (tid % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qi[h] < L) lse[(size_t)bh * L + qi[h]] = m[h] * kLn2 + logf(den[h]);
  }
}

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const int* __restrict__ seg, const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dq, int L, int heads, float scale,
                          bool causal) {
  using R = RingPlan<D, STAGES, 2>;
  extern __shared__ char smem_raw[];
  char* smem = align_atom(smem_raw);
  char* qs = smem;
  char* dos = smem + R::kTile;
  RowVec* vec = reinterpret_cast<RowVec*>(smem + R::kVec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + R::kBars);  // [0] resident, [1 + s] ring stage s
  int* scratch = reinterpret_cast<int*>(smem + R::kScratch);
  const int n_blk = (L + kBlock - 1) / kBlock;
  int* flags = reinterpret_cast<int*>(smem + R::kList);
  int* list = flags + n_blk;
  auto ks = [&](int s) { return smem + R::kRing + s * 2 * R::kTile; };
  auto vs = [&](int s) { return smem + R::kRing + s * 2 * R::kTile + R::kTile; };

  // the causal work of a q block grows with its index: the heaviest first
  const int bh = blockIdx.x, qb = n_blk - 1 - (int)blockIdx.y, q0 = qb * kBlock;
  const int tid = threadIdx.x;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;

  init_barriers(bars, 1 + STAGES);
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * R::kTile);
    load_tile_tma<D>(qs, &tm_q, &bars[0], q0, bh);
    load_tile_tma<D>(dos, &tm_do, &bars[0], q0, bh);
  }
  // this thread's two q rows: their lse (scaled by log2 e), delta and id
  int qi[2], seg_q[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = q0 + acc_row(2 * h);
    const bool in = qi[h] < L;
    lse2[h] = in ? lse[(size_t)bh * L + qi[h]] * kLog2e : 0.0f;
    dlt[h] = in ? delta[(size_t)bh * L + qi[h]] : 0.0f;
    seg_q[h] = seg_b && in ? seg_b[qi[h]] : 0;
  }
  const float scale2 = scale * kLog2e;
  const int n_vis = visit_list(seg_b, L, q0, 0, causal ? qb + 1 : n_blk, flags, list, scratch);

  // ring stage s takes kv block kb: K, V by TMA, the keys' ids by the
  // threads, read into a register (fetch) well before they are stored
  auto fetch = [&](int kb) {
    const int j = kb * kBlock + tid;
    return seg_b && tid < kBlock && j < L ? seg_b[j] : -1;
  };
  auto issue = [&](int s, int kb, int ids) {
    if (tid == 0) {
      mbar_expect_tx(&bars[1 + s], 2 * R::kTile);
      load_tile_tma<D>(ks(s), &tm_k, &bars[1 + s], kb * kBlock, bh);
      load_tile_tma<D>(vs(s), &tm_v, &bars[1 + s], kb * kBlock, bh);
    }
    if (tid < kBlock) vec[s].seg[tid] = ids;
  };
  {
    int ids[STAGES];
#pragma unroll
    for (int i = 0; i < STAGES; ++i) ids[i] = i < n_vis ? fetch(list[i]) : -1;
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
      if (i < n_vis) issue(i, list[i], ids[i]);
  }
  __syncthreads();  // the ring's ids are in shared memory
  mbar_wait(&bars[0], 0);

  float acc[D / 64][32];
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[pn][i] = 0.0f;

  for (int it = 0; it < n_vis; ++it) {
    const int s = it % STAGES, k0 = list[it] * kBlock;
    const bool refill = it + STAGES < n_vis;
    const int ahead = refill ? fetch(list[it + STAGES]) : -1;
    mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    pin(sc);
    pin(dp);
    wg_fence();
    tile_abt<D>(sc, qs, ks(s));   // S = Q K^T
    tile_abt<D>(dp, dos, vs(s));  // dP = dO V^T
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);
    // ds = p (dp - delta) scale in the accumulators' registers, packed as
    // the A fragments of dq += ds K
    uint32_t frag[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = acc_col(i + e), kj = k0 + c;
        const bool keep = kj < L && (!causal || kj <= qi[h]) && (!seg_b || vec[s].seg[c] == seg_q[h]);
        const float p = keep ? exp2f(fmaf(sc[i + e], scale2, -lse2[h])) : 0.0f;
        ds[e] = p * (dp[i + e] - dlt[h]) * scale;
      }
      frag[i >> 3][(i & 7) >> 1] = pack_bf16(ds[0], ds[1]);
    }
    pin(frag);
    wg_fence();
    tile_fb<D>(acc, frag, ks(s));  // dQ += dS K
    wg_commit();
    wg_wait_all();
    pin(frag);
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) pin(acc[pn]);
    __syncthreads();  // every thread is done with stage s
    if (refill) issue(s, list[it + STAGES], ahead);
  }

  const size_t base = (size_t)bh * L * D;
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = q0 + acc_row(i);
      if (r < L)
        *reinterpret_cast<uint32_t*>(dq + base + (size_t)r * D + pn * 64 + acc_col(i)) =
            pack_bf16(acc[pn][i], acc[pn][i + 1]);
    }
}

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const int* __restrict__ seg, const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int L,
                           int heads, float scale, bool causal) {
  using R = RingPlan<D, STAGES, 2>;
  extern __shared__ char smem_raw[];
  char* smem = align_atom(smem_raw);
  char* ks = smem;
  char* vs = smem + R::kTile;
  RowVec* vec = reinterpret_cast<RowVec*>(smem + R::kVec);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + R::kBars);  // [0] resident, [1 + s] ring stage s
  int* scratch = reinterpret_cast<int*>(smem + R::kScratch);
  const int n_blk = (L + kBlock - 1) / kBlock;
  int* flags = reinterpret_cast<int*>(smem + R::kList);
  int* list = flags + n_blk;
  auto qs = [&](int s) { return smem + R::kRing + s * 2 * R::kTile; };
  auto dos = [&](int s) { return smem + R::kRing + s * 2 * R::kTile + R::kTile; };

  // the causal work of a kv block shrinks with its index: in launch order,
  // the heaviest first
  const int bh = blockIdx.x, kb = blockIdx.y, k0 = kb * kBlock;
  const int tid = threadIdx.x;
  const int* seg_b = seg ? seg + (size_t)(bh / heads) * L : nullptr;
  const float* lse_b = lse + (size_t)bh * L;
  const float* delta_b = delta + (size_t)bh * L;

  init_barriers(bars, 1 + STAGES);
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * R::kTile);
    load_tile_tma<D>(ks, &tm_k, &bars[0], k0, bh);
    load_tile_tma<D>(vs, &tm_v, &bars[0], k0, bh);
  }
  const int n_vis = visit_list(seg_b, L, k0, causal ? kb : 0, n_blk, flags, list, scratch);

  // ring stage s takes q block qb: Q, dO by TMA, the rows' lse (scaled by
  // log2 e), delta and ids by the threads, read into registers (fetch)
  // well before they are stored: threads 0-63 a row's lse and delta,
  // threads 64-127 its id
  struct Rows {
    float a, b;
    int id;
  };
  auto fetch = [&](int qb) {
    const int q = qb * kBlock + tid % kBlock;
    const bool in = q < L;
    Rows r{0.0f, 0.0f, -1};
    if (tid < kBlock) {
      r.a = in ? lse_b[q] * kLog2e : 0.0f;
      r.b = in ? delta_b[q] : 0.0f;
    } else if (seg_b && in) {
      r.id = seg_b[q];
    }
    return r;
  };
  auto issue = [&](int s, int qb, const Rows& rows) {
    if (tid == 0) {
      mbar_expect_tx(&bars[1 + s], 2 * R::kTile);
      load_tile_tma<D>(qs(s), &tm_q, &bars[1 + s], qb * kBlock, bh);
      load_tile_tma<D>(dos(s), &tm_do, &bars[1 + s], qb * kBlock, bh);
    }
    const int r = tid % kBlock;
    if (tid < kBlock) {
      vec[s].lse2[r] = rows.a;
      vec[s].delta[r] = rows.b;
    } else {
      vec[s].seg[r] = rows.id;
    }
  };
  {
    Rows rows[STAGES];
#pragma unroll
    for (int i = 0; i < STAGES; ++i) rows[i] = i < n_vis ? fetch(list[i]) : Rows{0.0f, 0.0f, -1};
#pragma unroll
    for (int i = 0; i < STAGES; ++i)
      if (i < n_vis) issue(i, list[i], rows[i]);
  }

  // this thread's two kv rows and their ids
  int kj[2], seg_k[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kj[h] = k0 + acc_row(2 * h);
    seg_k[h] = seg_b && kj[h] < L ? seg_b[kj[h]] : 0;
  }
  const float scale2 = scale * kLog2e;
  __syncthreads();  // the ring's row vectors are in shared memory
  mbar_wait(&bars[0], 0);

  float dk_acc[D / 64][32], dv_acc[D / 64][32];
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[pn][i] = dv_acc[pn][i] = 0.0f;

  for (int it = 0; it < n_vis; ++it) {
    const int s = it % STAGES, q0 = list[it] * kBlock;
    const bool refill = it + STAGES < n_vis;
    const Rows ahead = refill ? fetch(list[it + STAGES]) : Rows{0.0f, 0.0f, -1};
    mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    // transposed scores: rows are this CTA's keys, columns the queries
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    pin(sc);
    pin(dp);
    wg_fence();
    tile_abt<D>(sc, ks, qs(s));   // S^T = K Q^T
    tile_abt<D>(dp, vs, dos(s));  // dP^T = V dO^T
    wg_commit();
    wg_wait_all();
    pin(sc);
    pin(dp);
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1, c = acc_col(i);  // c is even: this pair is columns c, c + 1
      const float2 l2 = *reinterpret_cast<const float2*>(&vec[s].lse2[c]);
      const float2 dl = *reinterpret_cast<const float2*>(&vec[s].delta[c]);
      const int2 sq = *reinterpret_cast<const int2*>(&vec[s].seg[c]);
      const float lv[2] = {l2.x, l2.y}, dlt[2] = {dl.x, dl.y};
      const int sv[2] = {sq.x, sq.y};
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + c + e;
        const bool keep = q < L && (!causal || kj[h] <= q) && (!seg_b || sv[e] == seg_k[h]);
        p[e] = keep ? exp2f(fmaf(sc[i + e], scale2, -lv[e])) : 0.0f;
        ds[e] = p[e] * (dp[i + e] - dlt[e]) * scale;
      }
      pf[i >> 3][(i & 7) >> 1] = pack_bf16(p[0], p[1]);
      dsf[i >> 3][(i & 7) >> 1] = pack_bf16(ds[0], ds[1]);
    }
    pin(pf);
    pin(dsf);
    wg_fence();
    tile_fb<D>(dv_acc, pf, dos(s));  // dV += P^T dO
    tile_fb<D>(dk_acc, dsf, qs(s));  // dK += dS^T Q
    wg_commit();
    wg_wait_all();
    pin(pf);
    pin(dsf);
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) {
      pin(dk_acc[pn]);
      pin(dv_acc[pn]);
    }
    __syncthreads();  // every thread is done with stage s
    if (refill) issue(s, list[it + STAGES], ahead);
  }

  const size_t base = (size_t)bh * L * D;
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = k0 + acc_row(i);
      if (r < L) {
        const size_t at = base + (size_t)r * D + pn * 64 + acc_col(i);
        *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(dk_acc[pn][i], dk_acc[pn][i + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack_bf16(dv_acc[pn][i], dv_acc[pn][i + 1]);
      }
    }
}

// The driver's tensor-map encoder, fetched through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// No tensor-map encoder, or it refused a map.
constexpr int kNoTensorMap = -2;

// N operands ([BH, L, D] bf16: q, k, v and, for the backward, dO) as 3-D
// tensor maps of 64 x 64 boxes, 128-byte swizzled; box rows past L read as
// zeros.
template <int N>
int make_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N], int bh, int L, int D) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return kNoTensorMap;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t box[3] = {64, kBlock, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  for (int i = 0; i < N; ++i) {
    CUresult r = enc(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptrs[i]), dims, strides, box,
                     unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kNoTensorMap;
  }
  return 0;
}

// Ring depth: 3 stages at D = 64, 2 at D = 128. A backward CTA holds 64 KB
// or 96 KB of tiles (3 or 2 CTAs an SM), a forward CTA 56 KB or 80 KB.
template <int D> constexpr int kStages = D == 64 ? 3 : 2;

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int bh,
                     int heads, int L, float scale, int causal, cudaStream_t stream) {
  constexpr int S = kStages<D>;
  CUtensorMap m[3];
  if (int err = make_maps(m, {q, k, v}, bh, L, D)) return err;
  const int n_blk = (L + kBlock - 1) / kBlock;
  const size_t smem = RingPlan<D, S, 1>::bytes(n_blk);
  auto kern = flash_fwd_wgmma_kernel<D, S>;
  cudaError_t err = allow_smem<flash_fwd_wgmma_kernel<D, S>>(smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(bh, n_blk), kThreads, smem, stream>>>(m[0], m[1], m[2], seg, static_cast<bf16*>(o), lse, L, heads,
                                                     scale, causal != 0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const int* seg, const void* dout, const float* lse,
                    const float* delta, void* dq, int bh, int heads, int L, float scale, int causal,
                    cudaStream_t stream) {
  constexpr int S = kStages<D>;
  CUtensorMap m[4];
  if (int err = make_maps(m, {q, k, v, dout}, bh, L, D)) return err;
  const int n_blk = (L + kBlock - 1) / kBlock;
  const size_t smem = RingPlan<D, S, 2>::bytes(n_blk);
  auto kern = flash_bwd_dq_wgmma_kernel<D, S>;
  cudaError_t err = allow_smem<flash_bwd_dq_wgmma_kernel<D, S>>(smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(bh, n_blk), kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], seg, lse, delta,
                                                     static_cast<bf16*>(dq), L, heads, scale, causal != 0);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const int* seg, const void* dout, const float* lse,
                     const float* delta, void* dk, void* dv, int bh, int heads, int L, float scale, int causal,
                     cudaStream_t stream) {
  constexpr int S = kStages<D>;
  CUtensorMap m[4];
  if (int err = make_maps(m, {q, k, v, dout}, bh, L, D)) return err;
  const int n_blk = (L + kBlock - 1) / kBlock;
  const size_t smem = RingPlan<D, S, 2>::bytes(n_blk);
  auto kern = flash_bwd_dkv_wgmma_kernel<D, S>;
  cudaError_t err = allow_smem<flash_bwd_dkv_wgmma_kernel<D, S>>(smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(bh, n_blk), kThreads, smem, stream>>>(m[0], m[1], m[2], m[3], seg, lse, delta,
                                                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, heads, scale,
                                                     causal != 0);
  return (int)cudaGetLastError();
}

// Unsupported head dim or dtype: the wrapper checks first, so this is a guard.
constexpr int kUnsupported = -1;

}  // namespace

// C interface for ctypes. dtype: 0 = float32, 1 = bfloat16; seg may be null
// (no fence); returns 0 or a cudaError_t code (kUnsupported for a bad D/dtype,
// kNoTensorMap when the driver's tensor-map encoder is missing or refuses).
extern "C" {

int tos_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o, float* lse, int bh,
                  int heads, int L, int D, int dtype, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_fwd_wgmma<64>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128) return launch_fwd_wgmma<128>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 64) return launch_fwd<float, 64>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 128) return launch_fwd<float, 128>(q, k, v, seg, o, lse, bh, heads, L, scale, causal, st);
  return kUnsupported;
}

int tos_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg, const void* dout,
                     const float* lse, const float* delta, void* dq, int bh, int heads, int L, int D, int dtype,
                     float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_dq_wgmma<64>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dq_wgmma<128>(q, k, v, seg, dout, lse, delta, dq, bh, heads, L, scale, causal, st);
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
    return launch_dkv_wgmma<64>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 1 && D == 128)
    return launch_dkv_wgmma<128>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, seg, dout, lse, delta, dk, dv, bh, heads, L, scale, causal, st);
  return kUnsupported;
}

}  // extern "C"
