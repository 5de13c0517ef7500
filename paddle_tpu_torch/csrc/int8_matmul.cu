// Dequant-fused matmul of a quantized serving bundle for Hopper (sm_90a):
// x [M, K] (float32 or bfloat16) @ dequant(w_q [K, N] int8, scale [N]
// float32) -> y [M, N] in x's dtype.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
//   _int8_matmul_kernel  (:908, called by _int8_matmul_call :918, "K9").
//
// Function, exactly the TPU kernel's body (:908-915):
//   w[k,n] = round_to_x_dtype((float)w_q[k,n] * scale[n])
//   y[m,n] = round_to_x_dtype(sum_k (float)x[m,k] * (float)w[k,n])
// the dequantized weight is rounded to x's dtype (a no-op in float32),
// products are summed in float32, and the output is rounded once. In
// bfloat16 this is not the XLA fallback's formula (:959 casts the scale to
// bfloat16 before the multiply); in float32 the two agree.
//
// Three paths; the caller's planner (ops/int8_kernels.int8_plan) picks one
// from (M, K, N, dtype) alone and passes its tiling in:
//
// 0 split-K, M <= 32 (served fc layers: ResNet-50's fc is 1..32 x 2048 x
//   1000). The bytes of w_q bound it (2 MB there), so the work is spread
//   over the card: a block owns 16 or 32 rows (the row tile fits M) x 64
//   columns x one of S contiguous K ranges, with S chosen so that column
//   tiles x S is about three blocks per SM. The K range is walked in
//   chunks of 32, double-buffered through registers; the int8 weight
//   streams in 16-byte loads where N allows it, is dequantized in
//   registers with the column scales (held in registers for the whole
//   range) and staged as float32. Products are float32 FMA on the CUDA
//   cores. Each block writes its float32 partial tile to workspace[s]; a
//   second pass adds the S partials in the fixed order s = 0, 1, ..., S-1
//   and rounds once to x's dtype. No atomics: deterministic. (S = 1 writes
//   y directly, and there is no second pass.)
// 1 tensor cores, bfloat16, M > 32 (the flagship's transforms, M = 2048):
//   the arithmetic rate bounds it (989 TFLOP/s in bfloat16). A block owns
//   64 x 64 outputs, 4 warps of 32 x 32. x tiles [64 rows][32 k] arrive by
//   cp.async through a 3-stage ring; the int8 tile [32 k][64 n] is
//   dequantized in registers, rounded to bfloat16 (exactly the body's
//   rounding) and stored k-major to shared memory (double-buffered). The
//   product runs as mma.sync.m16n8k16 bf16 with float32 accumulators, the
//   operands loaded by ldmatrix (.trans for the k-major weight).
//   mma.sync rather than wgmma: these products are small (K = 128 or 256,
//   1 GFLOP), so a 64-row warpgroup tile with its descriptor-addressed,
//   swizzled shared layout would buy little over the warp-level product,
//   while the int8 dequant step needs the weight tile written by the
//   threads anyway; mma.sync keeps the tile small enough for 512 blocks.
// 2 CUDA cores, float32, M > 32: the body's products are full float32 and
//   the port keeps TF32 off, so the float32 rate bounds it (67 TFLOP/s).
//   A block owns 128 x 64 outputs, each of its 128 threads an 8 x 8
//   micro-tile (8 + 2 shared loads for 64 FMA); x tiles [128][16] arrive by
//   cp.async through a 3-stage ring, the weight as in path 1 but float32.
//
// Every edge is predicated: any M, K, N >= 1. x goes through cp.async when
// its rows are 16-byte aligned (K a multiple of 16 bytes; the wrapper
// aligns the base), else through plain loads into the same ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

constexpr int kPathSplitK = 0;
constexpr int kPathTensorBf16 = 1;
constexpr int kPathFloat32 = 2;

// error codes beside cudaError_t values (which are all >= 0)
constexpr int kErrBadArgument = -1;
constexpr int kErrTooLarge = -2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the dequantized weight rounded to x's dtype, widened back to float32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 int8 weights of row kk, columns col .. col+15: one 16-byte load (or
// two 8-byte ones) where N and the row start allow it, else byte loads
// predicated on N; zeros past K.
__device__ __forceinline__ void load_w16(const int8_t* __restrict__ w, int kk,
                                         int col, int k, int n, int w_vec,
                                         int8_t (&reg)[16]) {
  const int8_t* src = w + static_cast<long long>(kk) * n + col;
  if (kk < k && col + 16 <= n && w_vec == 16) {
    *reinterpret_cast<int4*>(reg) = __ldg(reinterpret_cast<const int4*>(src));
  } else if (kk < k && col + 16 <= n && w_vec == 8) {
    reinterpret_cast<int2*>(reg)[0] = __ldg(reinterpret_cast<const int2*>(src));
    reinterpret_cast<int2*>(reg)[1] =
        __ldg(reinterpret_cast<const int2*>(src) + 1);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      reg[j] = (kk < k && col + j < n) ? src[j] : int8_t(0);
    }
  }
}

// the scales of columns col .. col+15 (0 past N)
__device__ __forceinline__ void load_scales(const float* __restrict__ scale,
                                            int col, int n, bool active,
                                            float (&s)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    s[j] = (active && col + j < n) ? __ldg(scale + col + j) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Path 0: split-K on the CUDA cores, M <= 32.

constexpr int kSkBN = 64;
constexpr int kSkBK = 32;
constexpr int kSkThreads = 128;

template <typename T, int BM>
__global__ void __launch_bounds__(kSkThreads)
i8_splitk(const T* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, T* __restrict__ y,
          float* __restrict__ ws, int m, int k, int n, int k_per_split,
          int w_vec) {
  constexpr int kRM = BM / 8;                       // rows per thread
  constexpr int kXPerThread = BM * kSkBK / kSkThreads;
  __shared__ float x_s[2][kSkBK][BM + 1];           // [k][row], padded
  __shared__ __align__(16) float w_s[2][kSkBK][kSkBN];  // [k][column]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kSkBN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(k, k_begin + k_per_split);
  const int n_chunks = (k_end - k_begin + kSkBK - 1) / kSkBK;

  const int w_row = tid / 4;          // 0..31
  const int w_col = (tid % 4) * 16;   // 0, 16, 32, 48
  float s[16];
  load_scales(scale, n0 + w_col, n, true, s);

  float x_reg[kXPerThread];
  __align__(16) int8_t w_reg[16];
  auto fetch = [&](int chunk) {
    const int k0 = k_begin + chunk * kSkBK;
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kSkThreads;
      const int row = idx / kSkBK;
      const int kk = k0 + idx % kSkBK;
      x_reg[i] = (row < m && kk < k_end)
                     ? to_float(x[static_cast<long long>(row) * k + kk])
                     : 0.f;
    }
    const int kk = k0 + w_row;
    load_w16(w, kk < k_end ? kk : k, n0 + w_col, k, n, w_vec, w_reg);
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kSkThreads;
      x_s[buf][idx % kSkBK][idx / kSkBK] = x_reg[i];
    }
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      float4 v;
      v.x = round_to<T>(static_cast<float>(w_reg[j]) * s[j]);
      v.y = round_to<T>(static_cast<float>(w_reg[j + 1]) * s[j + 1]);
      v.z = round_to<T>(static_cast<float>(w_reg[j + 2]) * s[j + 2]);
      v.w = round_to<T>(static_cast<float>(w_reg[j + 3]) * s[j + 3]);
      *reinterpret_cast<float4*>(&w_s[buf][w_row][w_col + j]) = v;
    }
  };

  const int ty = tid / 16;  // rows ty*kRM .. of the tile
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3
  float acc[kRM][4];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (n_chunks > 0) {
    fetch(0);
    stage(0);
  }
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) fetch(chunk + 1);
#pragma unroll 8
    for (int kk = 0; kk < kSkBK; ++kk) {
      float a[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) a[i] = x_s[buf][kk][ty * kRM + i];
      const float4 b = *reinterpret_cast<const float4*>(&w_s[buf][kk][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (chunk + 1 < n_chunks) stage(buf ^ 1);
    __syncthreads();
  }

  float* part = ws == nullptr
                    ? nullptr
                    : ws + static_cast<long long>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = ty * kRM + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= n) continue;
      const long long at = static_cast<long long>(row) * n + col;
      if (part != nullptr) {
        part[at] = acc[i][j];
      } else {
        store_out(y + at, acc[i][j]);
      }
    }
  }
}

// y[i] = round(sum over s = 0, 1, ..., splits-1 of ws[s][i]), in that order
template <typename T>
__global__ void __launch_bounds__(256)
i8_reduce(const float* __restrict__ ws, T* __restrict__ y, long long count,
          int splits) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += ws[z * count + i];
    store_out(y + i, sum);
  }
}

// ---------------------------------------------------------------------------
// The x ring of paths 1 and 2: rows [m0, m0+BM) x k [k0, k0+BK) of x into
// a [BM][BK + pad] tile, by 16-byte cp.async with zero-fill (VEC) or by
// plain predicated loads.

template <typename T, int BM, int BK, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void load_x_tile(T (*tile)[LD],
                                            const T* __restrict__ x, int m0,
                                            int k0, int m, int k, int tid) {
  constexpr int kPer = 16 / sizeof(T);       // elements per 16 bytes
  constexpr int kSegs = BM * BK / kPer;      // 16-byte segments per tile
  static_assert(kSegs % THREADS == 0, "segments per thread");
#pragma unroll
  for (int i = 0; i < kSegs / THREADS; ++i) {
    const int seg = tid + i * THREADS;
    const int row = seg / (BK / kPer);
    const int col = (seg % (BK / kPer)) * kPer;
    const int gr = m0 + row;
    const int kk = k0 + col;
    if (VEC) {
      const int left = (gr < m) ? (k - kk) * static_cast<int>(sizeof(T)) : 0;
      const int bytes = left < 0 ? 0 : (left > 16 ? 16 : left);
      const T* src = bytes > 0 ? x + static_cast<long long>(gr) * k + kk : x;
      sm90::cp_async16(&tile[row][col], src, bytes);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        tile[row][col + j] =
            (gr < m && kk + j < k) ? x[static_cast<long long>(gr) * k + kk + j]
                                   : T(0.f);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Path 1: tensor cores, bfloat16, M > 32.

constexpr int kTcBM = 64;
constexpr int kTcBN = 64;
constexpr int kTcBK = 32;
constexpr int kTcThreads = 128;
constexpr int kTcStages = 3;
constexpr int kTcXLd = kTcBK + 8;   // 80-byte rows: ldmatrix conflict-free
constexpr int kTcWLd = kTcBN + 8;   // 144-byte rows

template <bool VEC>
__global__ void __launch_bounds__(kTcThreads)
i8_tc_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
           int m, int k, int n, int w_vec) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kTcStages][kTcBM][kTcXLd];
  __shared__ __align__(16) __nv_bfloat16 w_s[2][kTcBK][kTcWLd];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * kTcBM;
  const int n0 = blockIdx.x * kTcBN;
  const int n_chunks = (k + kTcBK - 1) / kTcBK;

  const int w_row = tid / 4;          // 0..31
  const int w_col = (tid % 4) * 16;   // 0, 16, 32, 48
  float s[16];
  load_scales(scale, n0 + w_col, n, true, s);
  __align__(16) int8_t w_reg[16];
  auto fetch_w = [&](int chunk) {
    load_w16(w, chunk * kTcBK + w_row, n0 + w_col, k, n, w_vec, w_reg);
  };
  auto stage_w = [&](int buf) {
    __align__(16) __nv_bfloat16 v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] = __float2bfloat16_rn(static_cast<float>(w_reg[j]) * s[j]);
    }
    uint4* dst = reinterpret_cast<uint4*>(&w_s[buf][w_row][w_col]);
    dst[0] = reinterpret_cast<const uint4*>(v)[0];
    dst[1] = reinterpret_cast<const uint4*>(v)[1];
  };
  auto load_x = [&](int chunk) {
    if (chunk < n_chunks) {
      load_x_tile<__nv_bfloat16, kTcBM, kTcBK, kTcXLd, kTcThreads, VEC>(
          x_s[chunk % kTcStages], x, m0, chunk * kTcBK, m, k, tid);
    }
    sm90::cp_async_commit();  // an empty group past the end keeps the count
  };

  const int wm = (warp % 2) * 32;  // the warp's 32 x 32 quarter
  const int wn = (warp / 2) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_x(0);
  load_x(1);
  fetch_w(0);
  stage_w(0);
  if (n_chunks > 1) fetch_w(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();  // this chunk's x has landed
    __syncthreads();           // ... for every thread; chunk-1 is consumed
    load_x(chunk + 2);
    if (chunk + 1 < n_chunks) {
      stage_w((chunk + 1) & 1);
      if (chunk + 2 < n_chunks) fetch_w(chunk + 2);
    }
    const int st = chunk % kTcStages;
    const int buf = chunk & 1;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sm90::ldmatrix_x4(
            a[mt], &x_s[st][wm + mt * 16 + lane % 16][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        sm90::ldmatrix_x4_trans(
            b[np], &w_s[buf][ks + lane % 8 + ((lane / 8) % 2) * 8]
                        [wn + np * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sm90::mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
                         b[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  sm90::cp_async_wait<0>();

  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + g + h * 8;
        const int col = n0 + wn + nt * 8 + t * 2;
        if (row >= m) continue;
        __nv_bfloat16* dst = y + static_cast<long long>(row) * n + col;
        const float v0 = acc[mt][nt][2 * h];
        const float v1 = acc[mt][nt][2 * h + 1];
        if (col + 1 < n && n % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < n) dst[0] = __float2bfloat16_rn(v0);
          if (col + 1 < n) dst[1] = __float2bfloat16_rn(v1);
        }
      }
}

// ---------------------------------------------------------------------------
// Path 2: CUDA cores, float32, M > 32.

constexpr int kF32BM = 128;
constexpr int kF32BN = 64;
constexpr int kF32BK = 16;
constexpr int kF32Threads = 128;
constexpr int kF32Stages = 3;
constexpr int kF32XLd = kF32BK + 4;  // 80-byte rows, 16-byte aligned

template <bool VEC>
__global__ void __launch_bounds__(kF32Threads)
i8_simt_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y, int m,
            int k, int n, int w_vec) {
  __shared__ __align__(16) float x_s[kF32Stages][kF32BM][kF32XLd];
  __shared__ __align__(16) float w_s[2][kF32BK][kF32BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kF32BM;
  const int n0 = blockIdx.x * kF32BN;
  const int n_chunks = (k + kF32BK - 1) / kF32BK;

  // threads 0..63 load the weight: row w_row of the chunk, 16 columns
  const bool w_loader = tid < kF32BK * kF32BN / 16;
  const int w_row = tid / 4;
  const int w_col = (tid % 4) * 16;
  float s[16];
  load_scales(scale, n0 + w_col, n, w_loader, s);
  __align__(16) int8_t w_reg[16];
  auto fetch_w = [&](int chunk) {
    if (w_loader) {
      load_w16(w, chunk * kF32BK + w_row, n0 + w_col, k, n, w_vec, w_reg);
    }
  };
  auto stage_w = [&](int buf) {
    if (!w_loader) return;
#pragma unroll
    for (int j = 0; j < 16; j += 4) {
      *reinterpret_cast<float4*>(&w_s[buf][w_row][w_col + j]) =
          make_float4(static_cast<float>(w_reg[j]) * s[j],
                      static_cast<float>(w_reg[j + 1]) * s[j + 1],
                      static_cast<float>(w_reg[j + 2]) * s[j + 2],
                      static_cast<float>(w_reg[j + 3]) * s[j + 3]);
    }
  };
  auto load_x = [&](int chunk) {
    if (chunk < n_chunks) {
      load_x_tile<float, kF32BM, kF32BK, kF32XLd, kF32Threads, VEC>(
          x_s[chunk % kF32Stages], x, m0, chunk * kF32BK, m, k, tid);
    }
    sm90::cp_async_commit();
  };

  // rows ty + 16 i (i = 0..7), columns tx*4 + {0..3} and 32 + tx*4 + {0..3}:
  // a warp's 4 row reads land in 4 banks, its column reads are contiguous
  const int tx = tid % 8;
  const int ty = tid / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_x(0);
  load_x(1);
  fetch_w(0);
  stage_w(0);
  if (n_chunks > 1) fetch_w(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();
    __syncthreads();
    load_x(chunk + 2);
    if (chunk + 1 < n_chunks) {
      stage_w((chunk + 1) & 1);
      if (chunk + 2 < n_chunks) fetch_w(chunk + 2);
    }
    const int st = chunk % kF32Stages;
    const int buf = chunk & 1;
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = x_s[st][ty + 16 * i][kk];
      const float4 b0 =
          *reinterpret_cast<const float4*>(&w_s[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&w_s[buf][kk][32 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 32 + tx * 4;
      float* dst = y + static_cast<long long>(row) * n + col;
      if (col + 3 < n && n % 4 == 0) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                        acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < n) dst[j] = acc[i][half * 4 + j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T>
int launch_splitk(const T* x, const int8_t* w, const float* scale, T* y,
                  float* ws, int m, int k, int n, int row_tile, int splits,
                  int k_per_split, int w_vec, cudaStream_t stream, int* info) {
  if (m > 32 || (row_tile != 16 && row_tile != 32) || m > row_tile ||
      splits < 1 || k_per_split < 1 || k_per_split % kSkBK != 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= k ||
      static_cast<long long>(splits) * k_per_split < k) {
    return kErrBadArgument;
  }
  if (splits > 65535) return kErrTooLarge;
  const dim3 grid((n + kSkBN - 1) / kSkBN, 1, splits);
  float* part = splits > 1 ? ws : nullptr;
  if (splits > 1 && ws == nullptr) return kErrBadArgument;
  if (row_tile == 16) {
    i8_splitk<T, 16><<<grid, kSkThreads, 0, stream>>>(
        x, w, scale, y, part, m, k, n, k_per_split, w_vec);
  } else {
    i8_splitk<T, 32><<<grid, kSkThreads, 0, stream>>>(
        x, w, scale, y, part, m, k, n, k_per_split, w_vec);
  }
  cudaError_t err = cudaGetLastError();
  info[0] = static_cast<int>(grid.x);
  info[1] = 1;
  info[2] = splits;
  info[3] = w_vec;
  info[4] = static_cast<int>(sizeof(float) * 2 * kSkBK *
                             (row_tile + 1 + kSkBN));
  info[5] = 1;
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(m) * n;
  long long blocks = (count + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  i8_reduce<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      ws, y, count, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, void* ws,
           int m, int k, int n, int path, int row_tile, int splits,
           int k_per_split, cudaStream_t stream, int* info) {
  // vector width of the weight loads: every row start is 16 (8) bytes
  // aligned when the base is and N is a multiple of 16 (8)
  const uintptr_t base = reinterpret_cast<uintptr_t>(w);
  const int w_vec = (n % 16 == 0 && base % 16 == 0)  ? 16
                    : (n % 8 == 0 && base % 8 == 0) ? 8
                                                    : 1;
  const T* xt = static_cast<const T*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  T* yt = static_cast<T*>(y);
  // x rows 16-byte aligned: cp.async; else plain loads into the same ring
  const bool x_vec = (static_cast<long long>(k) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (path == kPathSplitK) {
    return launch_splitk<T>(xt, wq, sc, yt, static_cast<float*>(ws), m, k, n,
                            row_tile, splits, k_per_split, w_vec, stream,
                            info);
  }
  if (splits != 1) return kErrBadArgument;
  int bm, bn, smem;
  if (path == kPathTensorBf16) {
    bm = kTcBM;
    bn = kTcBN;
    smem = static_cast<int>(sizeof(__nv_bfloat16) *
                            (kTcStages * kTcBM * kTcXLd + 2 * kTcBK * kTcWLd));
  } else if (path == kPathFloat32) {
    bm = kF32BM;
    bn = kF32BN;
    smem = static_cast<int>(sizeof(float) * (kF32Stages * kF32BM * kF32XLd +
                                             2 * kF32BK * kF32BN));
  } else {
    return kErrBadArgument;
  }
  if (row_tile != bm) return kErrBadArgument;
  const long long m_tiles = (static_cast<long long>(m) + bm - 1) / bm;
  if (m_tiles > 65535) return kErrTooLarge;
  const dim3 grid((n + bn - 1) / bn, static_cast<unsigned>(m_tiles));
  if constexpr (sizeof(T) == 2) {
    if (path != kPathTensorBf16) return kErrBadArgument;
    if (x_vec) {
      i8_tc_bf16<true><<<grid, kTcThreads, 0, stream>>>(xt, wq, sc, yt, m, k,
                                                        n, w_vec);
    } else {
      i8_tc_bf16<false><<<grid, kTcThreads, 0, stream>>>(xt, wq, sc, yt, m,
                                                         k, n, w_vec);
    }
  } else {
    if (path != kPathFloat32) return kErrBadArgument;
    if (x_vec) {
      i8_simt_f32<true><<<grid, kF32Threads, 0, stream>>>(xt, wq, sc, yt, m,
                                                          k, n, w_vec);
    } else {
      i8_simt_f32<false><<<grid, kF32Threads, 0, stream>>>(xt, wq, sc, yt, m,
                                                           k, n, w_vec);
    }
  }
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = 1;
  info[3] = w_vec;
  info[4] = smem;
  info[5] = 1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). x [m, k], w [k, n] int8,
// scale [n] float32, y [m, n]; ws [splits, m, n] float32 when path 0 runs
// with splits > 1 (else unused); all contiguous. path 0 split-K (row_tile
// 16 or 32 >= m, splits contiguous K ranges of k_per_split, a multiple of
// 32), 1 tensor cores (bfloat16; row_tile 64), 2 CUDA cores (float32;
// row_tile 128); splits 1 for paths 1 and 2. info receives {column tiles,
// row tiles, splits, weight load width in bytes, static shared memory bytes
// of the main kernel, launches made (one per call: the second pass of
// split-K included)}. Returns 0, a cudaError_t value, or a negative code
// above.
int int8_matmul(int dtype, const void* x, const void* w, const void* scale,
                void* y, void* ws, int m, int k, int n, int path,
                int row_tile, int splits, int k_per_split, int device,
                void* stream, int* info) {
  if (m < 1 || k < 1 || n < 1) return kErrBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, w, scale, y, ws, m, k, n, path, row_tile, splits,
                         k_per_split, s, info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, scale, y, ws, m, k, n, path, row_tile,
                                 splits, k_per_split, s, info);
  }
  return kErrBadArgument;
}

const char* int8_matmul_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code, an empty shape, or a plan the path "
             "does not take)";
    case kErrTooLarge:
      return "more than 65535 row tiles or splits";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
