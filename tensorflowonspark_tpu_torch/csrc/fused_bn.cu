// BatchNorm reductions for Hopper (sm_90a): bn_stats and bn_bwd_reduce.
//
// Replace two Pallas TPU kernels of the JAX package's
// tensorflowonspark_tpu/ops/fused_bn.py:
//   bn_stats_kernel       <- _stats_kernel       (pallas_call in _bn_stats)
//   bn_bwd_reduce_kernel  <- _bwd_reduce_kernel  (first pallas_call in _fused_bn_2d_bwd)
//
// Input is an [R, C] row-major activation (channels last: an NHWC tensor's
// free [N*H*W, C] view) in f32, bf16 or f16; the per-channel vectors and the
// outputs are f32 [C].
//   bn_stats:      mean = sum(x) / R, var = max(sum(x^2) / R - mean^2, 0), the
//                  reference's own formula (not Welford), in f32 with 1/R
//                  as a factor;
//   bn_bwd_reduce: dgamma = sum(dy * xhat), dbeta = sum(dy), with
//                  xhat = (x - mean) * rsqrt(var + eps) from the saved statistics.
//
// Bound on an H100 SXM: a few flops per element streamed once from device
// memory, so the bytes bind (3.35 TB/s): bn_stats reads 2RC bytes in bf16,
// bn_bwd_reduce 4RC. The TPU kernels carry their sums in VMEM along a
// sequential grid; a Hopper grid runs in no order. The design, for the bytes
// and for the fixed cost of a launch:
// * A CTA (256 threads) owns a strip of channels, one 128-byte segment of
//   each row, and a contiguous range of rows, its split. Each thread reads
//   16 bytes of a row (8 bf16 channels) and steps down the rows; the 8 lanes
//   of a strip read neighbouring pieces, so a warp reads whole 128-byte row
//   segments of 4 rows. A thread keeps eight 16-byte loads in flight
//   (bn_stats) or four of each input (bn_bwd_reduce): 32 KB a CTA.
// * The sums come out correctly rounded to f32 (nearly always), as the
//   plain version's f64 sums do: a thread adds the rows of one round of
//   loads (4 or 8) in f32 registers, folds that short sum into an f64
//   accumulator, and everything after the thread (the CTA's combination,
//   the partials, the finisher) is f64. An f32 gradient step is sensitive
//   to the last bits of a layer's statistics: two f32 summation orders of
//   the same activation move a ResNet-50 step's gradients about 2e-4 apart
//   (PERF.md, PR 5), so the only order both sides can share is the exact
//   one. The f64 work is one conversion and one add a channel a round.
// * The host sizes the split count to the work (reduce_geometry in
//   ops/fused_bn.py): at least one round of those loads a CTA, at most two
//   CTAs an SM over the whole grid, so small layers take few CTAs and the
//   largest fill the card in one wave. Narrow strips give a wide layer many
//   strips, each finished by its own CTA from a few partials.
// * The CTA adds its row lanes in a fixed order (an xor tree inside each
//   warp, then the warps in order through shared memory) into one partial
//   per channel and sum, and writes them to a workspace.
// * The finisher is folded in. Each CTA, after its partials and a
//   __threadfence(), takes a ticket on its strip's counter (atomicAdd). The
//   CTA that draws the last ticket reads the strip's partials back past L1
//   (ld.global.cg), adds them in a fixed order (each of its threads adds a
//   contiguous run of splits in split order, then the runs are added in
//   order), writes the outputs and resets the counter to 0 for the next
//   call. No CTA waits on another, there is no grid barrier, and the result
//   does not depend on which CTA finishes last.
// * An operand whose base pointer or row pitch is not a multiple of 16 bytes
//   takes the scalar path of the same kernel (one element a thread).
// * Under data parallelism the statistics and their gradient are taken over
//   the global batch (the JAX package's SPMD step computes them over the
//   whole sharded batch). Then each kernel runs in its split mode: the
//   finishing CTA writes the strip's f64 sums to a [2, C] buffer instead of
//   rounding them, the caller all-reduces that buffer across ranks, and
//   bn_finish_kernel rounds the global sums with the same code as the single
//   launch's finisher (round_out), so at one rank a split launch and a single
//   launch agree bitwise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 32;  // column lanes of a strip: one warp's width
constexpr int kMaxWidth = 64;  // channels of a strip: a 128-byte bf16 row segment

using bf16 = __nv_bfloat16;

// 16 bytes of a row, unpacked to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);  // the lower half is the first element
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<__half> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __half2_raw raw;
      raw.x = static_cast<unsigned short>(w[i] & 0xffffu);
      raw.y = static_cast<unsigned short>(w[i] >> 16);
      const float2 p = __half22float2(__half2(raw));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// What a thread loads at a time: 16 bytes (kVec) or one element.
template <typename T, bool kVec>
struct Path {
  static constexpr int kN = Vec<T>::kN;
  using Raw = uint4;
  __device__ static Raw load(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void unpack(const Raw& r, float* f) { Vec<T>::unpack(r, f); }
};

template <typename T>
struct Path<T, false> {
  static constexpr int kN = 1;
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = to_f32(r); }
};

// A thread's place: column lane and row lane inside the CTA's strip and split.
struct Place {
  int col_lane, row_lane, row_lanes, width, c0, r_begin, r_end;
  __device__ Place(int lanes, int n, int rows, int rows_per_split) {
    col_lane = threadIdx.x & (lanes - 1);
    row_lane = threadIdx.x / lanes;
    row_lanes = kThreads / lanes;
    width = lanes * n;
    c0 = blockIdx.x * width + col_lane * n;
    r_begin = blockIdx.y * rows_per_split;
    r_end = min(rows, r_begin + rows_per_split);
  }
};

// Reads partials past L1 (the writes of other CTAs are in L2). The asm is
// volatile, so the compiler keeps it after the fence that precedes it.
template <int kG>
__device__ __forceinline__ void load_cg(const double* p, double* v);

template <>
__device__ __forceinline__ void load_cg<2>(const double* p, double* v) {
  asm volatile("ld.global.cg.v2.f64 {%0, %1}, [%2];" : "=d"(v[0]), "=d"(v[1]) : "l"(p) : "memory");
}

template <>
__device__ __forceinline__ void load_cg<1>(const double* p, double* v) {
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v[0]) : "l"(p) : "memory");
}

// Adds the CTA's row lanes (each thread's f64 sums) in a fixed order into
// one partial per channel of each sum, writes them at row blockIdx.y of the
// f64 [2, splits, C] partials and takes a ticket on the strip's counter.
// True in the CTA that completes the strip (every other CTA's partials are
// then visible to it).
template <int kN>
__device__ bool cta_partials(double* a, double* b, const Place& pl, int lanes, int ch, double* partials,
                             unsigned* counters) {
  __shared__ double red[2][kWarps][kMaxWidth];
  __shared__ bool last;
  // lanes of one warp that share a column lane, added by an xor tree (a + b
  // and b + a are the same double, so every lane of a group ends equal)
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
      b[i] += __shfl_xor_sync(0xffffffffu, b[i], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < lanes) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      red[0][warp][pl.col_lane * kN + i] = a[i];
      red[1][warp][pl.col_lane * kN + i] = b[i];
    }
  }
  __syncthreads();
  const int splits = gridDim.y;
  if (threadIdx.x < pl.width) {
    double ta = red[0][0][threadIdx.x], tb = red[1][0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      ta += red[0][w][threadIdx.x];
      tb += red[1][w][threadIdx.x];
    }
    const int c = blockIdx.x * pl.width + threadIdx.x;
    if (c < ch) {
      partials[static_cast<size_t>(blockIdx.y) * ch + c] = ta;
      partials[static_cast<size_t>(splits + blockIdx.y) * ch + c] = tb;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// One channel's outputs from its two f64 sums: each sum rounded to f32 once;
// with stats, (sum x, sum x^2) then become (mean, biased var) by the
// reference's f32 formula over rows rows. The single launch's finisher and
// bn_finish_kernel (the split launch's) both end here, so the two round alike.
__device__ __forceinline__ void round_out(double ta, double tb, bool stats, int rows, float* out0,
                                          float* out1) {
  const float sa = __double2float_rn(ta), sb = __double2float_rn(tb);
  if (stats) {
    // 1/R rounded to f32 from f64, as the plain version's scalar is
    const float inv_n = __double2float_rn(1.0 / static_cast<double>(rows));
    const float m = __fmul_rn(sa, inv_n);
    *out0 = m;
    *out1 = fmaxf(__fsub_rn(__fmul_rn(sb, inv_n), __fmul_rn(m, m)), 0.0f);
  } else {
    *out0 = sa;
    *out1 = sb;
  }
}

// The last CTA of a strip: the strip's f64 partials of both sums added in a
// fixed order. Thread t takes unit t % units (kG channels) and the run of
// splits number t / units; each run is added in split order, then the runs
// in order. The sums are rounded to f32 once; kStats then turns (sum x,
// sum x^2) into (mean, biased var) by the reference's f32 formula. In the
// split mode (sums not null) the f64 sums themselves go to sums [2, C], for
// an all-reduce across ranks and bn_finish_kernel after it.
template <int kG, bool kStats>
__device__ void finish(const double* partials, unsigned* counters, int width, int ch, int rows,
                       float* out0, float* out1, double* sums) {
  __shared__ double fin[2][kThreads * kG];
  const int splits = gridDim.y;
  const int units = width / kG;
  const int runs = kThreads / units;
  const int unit = threadIdx.x % units, run = threadIdx.x / units;
  const int per = (splits + runs - 1) / runs;
  const int s_lo = min(splits, run * per), s_hi = min(splits, s_lo + per);
  const int c = blockIdx.x * width + unit * kG;
  double a[kG] = {}, b[kG] = {};
  if (c < ch) {
    const double* pa = partials + c;
    const double* pb = partials + static_cast<size_t>(splits) * ch + c;
    constexpr int kBatch = 8;  // splits whose loads are in flight together
    int s = s_lo;
    for (; s + kBatch <= s_hi; s += kBatch) {
      double va[kBatch][kG], vb[kBatch][kG];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        load_cg<kG>(pa + static_cast<size_t>(s + j) * ch, va[j]);
        load_cg<kG>(pb + static_cast<size_t>(s + j) * ch, vb[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          a[g] += va[j][g];
          b[g] += vb[j][g];
        }
      }
    }
    for (; s < s_hi; ++s) {
      double va[kG], vb[kG];
      load_cg<kG>(pa + static_cast<size_t>(s) * ch, va);
      load_cg<kG>(pb + static_cast<size_t>(s) * ch, vb);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        a[g] += va[g];
        b[g] += vb[g];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    fin[0][run * width + unit * kG + g] = a[g];
    fin[1][run * width + unit * kG + g] = b[g];
  }
  __syncthreads();
  if (threadIdx.x < width) {
    const int cc = blockIdx.x * width + threadIdx.x;
    if (cc < ch) {
      double ta = fin[0][threadIdx.x], tb = fin[1][threadIdx.x];
      for (int k = 1; k < runs; ++k) {
        ta += fin[0][k * width + threadIdx.x];
        tb += fin[1][k * width + threadIdx.x];
      }
      if (sums) {
        sums[cc] = ta;
        sums[static_cast<size_t>(ch) + cc] = tb;
      } else {
        round_out(ta, tb, kStats, rows, out0 + cc, out1 + cc);
      }
    }
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, int rows, int ch, int lanes, int rows_per_split,
                    double* __restrict__ partials, unsigned* __restrict__ counters,
                    float* __restrict__ mean, float* __restrict__ var, double* __restrict__ sums) {
  using P = Path<T, kVec>;
  constexpr int kN = P::kN;
  constexpr int kUnroll = 8;
  const Place pl(lanes, kN, rows, rows_per_split);
  double s[kN] = {}, q[kN] = {};
  if (pl.c0 < ch) {
    const T* base = x + pl.c0;
    for (int r = pl.r_begin + pl.row_lane; r < pl.r_end; r += kUnroll * pl.row_lanes) {
      typename P::Raw raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * pl.row_lanes;
        if (rr < pl.r_end) raw[u] = P::load(base + static_cast<size_t>(rr) * ch);
      }
      float bs[kN] = {}, bq[kN] = {};  // this round's rows, in f32
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * pl.row_lanes < pl.r_end) {
          float v[kN];
          P::unpack(raw[u], v);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            bs[i] += v[i];
            bq[i] = fmaf(v[i], v[i], bq[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        s[i] += static_cast<double>(bs[i]);
        q[i] += static_cast<double>(bq[i]);
      }
    }
  }
  if (cta_partials<kN>(s, q, pl, lanes, ch, partials, counters))
    finish<kVec ? 2 : 1, true>(partials, counters, pl.width, ch, rows, mean, var, sums);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ var, float eps,
                         int rows, int ch, int lanes, int rows_per_split,
                         double* __restrict__ partials, unsigned* __restrict__ counters,
                         float* __restrict__ dgamma, float* __restrict__ dbeta,
                         double* __restrict__ sums) {
  using P = Path<T, kVec>;
  constexpr int kN = P::kN;
  constexpr int kUnroll = 4;
  const Place pl(lanes, kN, rows, rows_per_split);
  double dg[kN] = {}, db[kN] = {};
  if (pl.c0 < ch) {
    float m[kN], inv[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      m[i] = mean[pl.c0 + i];
      inv[i] = rsqrtf(var[pl.c0 + i] + eps);
    }
    const T* bx = x + pl.c0;
    const T* bdy = dy + pl.c0;
    for (int r = pl.r_begin + pl.row_lane; r < pl.r_end; r += kUnroll * pl.row_lanes) {
      typename P::Raw rx[kUnroll], rdy[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * pl.row_lanes;
        if (rr < pl.r_end) {
          rx[u] = P::load(bx + static_cast<size_t>(rr) * ch);
          rdy[u] = P::load(bdy + static_cast<size_t>(rr) * ch);
        }
      }
      float bg[kN] = {}, bb[kN] = {};  // this round's rows, in f32
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * pl.row_lanes < pl.r_end) {
          float vx[kN], vdy[kN];
          P::unpack(rx[u], vx);
          P::unpack(rdy[u], vdy);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            bg[i] = fmaf(vdy[i], (vx[i] - m[i]) * inv[i], bg[i]);
            bb[i] += vdy[i];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        dg[i] += static_cast<double>(bg[i]);
        db[i] += static_cast<double>(bb[i]);
      }
    }
  }
  if (cta_partials<kN>(dg, db, pl, lanes, ch, partials, counters))
    finish<kVec ? 2 : 1, false>(partials, counters, pl.width, ch, rows, dgamma, dbeta, sums);
}

// The host's geometry, checked so that no launch reads or writes out of
// bounds: lanes a power of two up to 32, the strips covering the channels,
// the splits the rows, and the 16-byte path only on aligned operands.
template <typename T>
bool geometry_ok(const void* a, const void* b, int vec, int rows, int ch, int lanes, int rows_per_split,
                 int strips, int splits) {
  const int n = vec ? Vec<T>::kN : 1;
  if (rows < 1 || ch < 1 || lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) != 0) return false;
  if (rows_per_split < 1 || splits < 1 || splits > 65535 || strips < 1) return false;
  if (lanes * n > kMaxWidth || static_cast<long long>(strips) * lanes * n < ch) return false;
  if (static_cast<long long>(splits) * rows_per_split < rows) return false;
  if (vec && ((static_cast<size_t>(ch) * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(b) % 16 != 0))
    return false;
  return true;
}

template <typename T>
int launch_stats(const void* x, int vec, int rows, int ch, int lanes, int rows_per_split, int strips,
                 int splits, double* partials, unsigned* counters, float* mean, float* var, double* sums,
                 cudaStream_t st) {
  if (!geometry_ok<T>(x, x, vec, rows, ch, lanes, rows_per_split, strips, splits)) return -1;
  const dim3 grid(strips, splits);
  const T* xt = static_cast<const T*>(x);
  if (vec)
    bn_stats_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, rows, ch, lanes, rows_per_split, partials,
                                                        counters, mean, var, sums);
  else
    bn_stats_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, rows, ch, lanes, rows_per_split, partials,
                                                         counters, mean, var, sums);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_reduce(const void* x, const void* dy, const float* mean, const float* var, float eps,
                      int vec, int rows, int ch, int lanes, int rows_per_split, int strips, int splits,
                      double* partials, unsigned* counters, float* dgamma, float* dbeta, double* sums,
                      cudaStream_t st) {
  if (!geometry_ok<T>(x, dy, vec, rows, ch, lanes, rows_per_split, strips, splits)) return -1;
  const dim3 grid(strips, splits);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (vec)
    bn_bwd_reduce_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, dyt, mean, var, eps, rows, ch, lanes,
                                                             rows_per_split, partials, counters, dgamma,
                                                             dbeta, sums);
  else
    bn_bwd_reduce_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, dyt, mean, var, eps, rows, ch, lanes,
                                                              rows_per_split, partials, counters, dgamma,
                                                              dbeta, sums);
  return static_cast<int>(cudaGetLastError());
}

// The split launch's finish: one thread a channel rounds the all-reduced
// f64 sums [2, C] exactly as the single launch's finisher does (round_out).
__global__ void __launch_bounds__(kThreads)
    bn_finish_kernel(const double* __restrict__ sums, int ch, int rows, bool stats, float* __restrict__ out0,
                     float* __restrict__ out1) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < ch) round_out(sums[c], sums[static_cast<size_t>(ch) + c], stats, rows, out0 + c, out1 + c);
}

}  // namespace

// The C interface (ctypes). dtype: 0 f32, 1 bf16, 2 f16. partials: f64
// [2, splits, C]; counters: one per strip, 0 between calls. sums: null for
// the single launch (f32 outputs), or f64 [2, C] for the split launch, whose
// f32 outputs then come from tos_bn_finish after the all-reduce. Returns 0,
// -1 for an unsupported dtype or geometry, or the CUDA error of the launch.
extern "C" {

int tos_bn_stats(const void* x, int dtype, int vec, int rows, int ch, int lanes, int rows_per_split,
                 int strips, int splits, double* partials, unsigned* counters, float* mean, float* var,
                 double* sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_stats<float>(x, vec, rows, ch, lanes, rows_per_split, strips, splits, partials, counters,
                                 mean, var, sums, st);
    case 1:
      return launch_stats<bf16>(x, vec, rows, ch, lanes, rows_per_split, strips, splits, partials, counters,
                                mean, var, sums, st);
    case 2:
      return launch_stats<__half>(x, vec, rows, ch, lanes, rows_per_split, strips, splits, partials,
                                  counters, mean, var, sums, st);
    default:
      return -1;
  }
}

int tos_bn_bwd_reduce(const void* x, const void* dy, const float* mean, const float* var, float eps,
                      int dtype, int vec, int rows, int ch, int lanes, int rows_per_split, int strips,
                      int splits, double* partials, unsigned* counters, float* dgamma, float* dbeta,
                      double* sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd_reduce<float>(x, dy, mean, var, eps, vec, rows, ch, lanes, rows_per_split, strips,
                                      splits, partials, counters, dgamma, dbeta, sums, st);
    case 1:
      return launch_bwd_reduce<bf16>(x, dy, mean, var, eps, vec, rows, ch, lanes, rows_per_split, strips,
                                     splits, partials, counters, dgamma, dbeta, sums, st);
    case 2:
      return launch_bwd_reduce<__half>(x, dy, mean, var, eps, vec, rows, ch, lanes, rows_per_split, strips,
                                       splits, partials, counters, dgamma, dbeta, sums, st);
    default:
      return -1;
  }
}

// The split launch's finish: sums f64 [2, C] (all-reduced) to f32 outputs;
// stats 1 gives (mean, var) over rows rows, 0 the two sums rounded.
int tos_bn_finish(const double* sums, int ch, int rows, int stats, float* out0, float* out1, void* stream) {
  if (ch < 1 || rows < 1) return -1;
  bn_finish_kernel<<<(ch + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sums, ch, rows, stats != 0, out0, out1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
