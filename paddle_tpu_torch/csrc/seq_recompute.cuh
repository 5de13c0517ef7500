// The recompute GEMM of the recurrent backward kernels (csrc/lstm_seq_bwd.cu
// and csrc/gru_seq_bwd.cu, each compiled on its own): out = A . B for every
// step of a sequence at once, [rows, K] x [K, N] with rows = T * B, handed
// tile by tile to an epilogue that adds the projection and applies the
// gate. The recurrences read what it leaves in a float32 workspace instead
// of recomputing it inside their serial step loops.
//
//   float32: CUDA cores in full float32 (the precision of the forward
//             kernels and of the reference), 128 x 64 tiles of z, 128
//             threads in 8 x 8 micro-tiles, K in chunks of 16
//             double-buffered through registers and shared memory.
//   bfloat16: tensor cores, mma.sync.m16n8k16 bf16 with float32
//             accumulators (products of bf16 values are exact in float32,
//             so the sums are the float32 version's up to order), 128 x 128
//             tiles, 8 warps of 64 x 32, K in chunks of 32 through a 3-stage
//             cp.async ring: A's rows by ldmatrix and B's k-major rows by
//             ldmatrix.trans, rows padded by 16 bytes so that ldmatrix is
//             free of bank conflicts.
//
// Requirements (the planners send only such shapes here): K % 8 == 0 and
// N % 8 == 0, the rows of A (pitch K) and of B (pitch ldb, ldb % 8 == 0)
// 16-byte aligned. The epilogue is a functor with
//   template <int kN> __device__ void operator()(long long row, int col,
//                                                const float (&v)[kN]) const
// receiving kN (4 from gemm in float32, else 2) consecutive columns of one
// row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_mma.cuh"

namespace seqre {

// ---------------------------------------------------------------- float32
constexpr int kFBM = 128;  // rows per block
constexpr int kFBN = 64;   // columns per block
constexpr int kFBK = 16;   // K chunk
constexpr int kFThreads = 128;
constexpr int kFALd = kFBM + 4;  // k-major A rows, 16-byte aligned

__device__ __forceinline__ void load4_ro(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <class Epi>
__global__ void __launch_bounds__(kFThreads)
gemm_f32(const float* __restrict__ a, const float* __restrict__ b, int rows,
         int k_dim, int n_dim, int ldb, Epi epi) {
  __shared__ __align__(16) float a_s[2][kFBK][kFALd];  // [k][row]
  __shared__ __align__(16) float b_s[2][kFBK][kFBN];   // [k][column]
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kFBM;
  const int n0 = blockIdx.y * kFBN;
  const int n_chunks = (k_dim + kFBK - 1) / kFBK;
  // loaders: A row tid (16 K values); B row tid / 8, columns (tid % 8) * 4
  // and 32 + (tid % 8) * 4
  const long long a_row = m0 + tid;
  const bool a_ok = a_row < rows;
  const int b_row = tid / 8;
  const int b_col = (tid % 8) * 4;
  float ra[kFBK], rb[8];
  auto fetch = [&](int chunk) {
    const int k0 = chunk * kFBK;
#pragma unroll
    for (int q = 0; q < kFBK / 4; ++q) {
      const int k = k0 + 4 * q;
      if (a_ok && k < k_dim) {
        load4_ro(a + a_row * k_dim + k, ra + 4 * q);
      } else {
        ra[4 * q] = ra[4 * q + 1] = ra[4 * q + 2] = ra[4 * q + 3] = 0.f;
      }
    }
    const int k = k0 + b_row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + b_col + 32 * h;
      if (k < k_dim && col < n_dim) {
        load4_ro(b + static_cast<long long>(k) * ldb + col, rb + 4 * h);
      } else {
        rb[4 * h] = rb[4 * h + 1] = rb[4 * h + 2] = rb[4 * h + 3] = 0.f;
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) a_s[buf][kk][tid] = ra[kk];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(&b_s[buf][b_row][b_col + 32 * h]) =
          make_float4(rb[4 * h], rb[4 * h + 1], rb[4 * h + 2], rb[4 * h + 3]);
    }
  };

  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns tx*4 + {0..3} and
  // 32 + tx*4 + {0..3}
  const int tx = tid % 8;
  const int ty = tid / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) fetch(chunk + 1);
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][kk][64 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&b_s[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][kk][32 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (chunk + 1 < n_chunks) stage(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 32 + tx * 4;
      if (col >= n_dim) continue;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      epi(row, col, v);
    }
  }
}

// --------------------------------------------------------------- bfloat16
constexpr int kTBM = 128;
constexpr int kTBN = 128;
constexpr int kTBK = 32;
constexpr int kTThreads = 256;
constexpr int kTStages = 3;
constexpr int kTALd = kTBK + 8;  // 80-byte rows
constexpr int kTBLd = kTBN + 8;  // 272-byte rows
constexpr int kTSmem = static_cast<int>(sizeof(__nv_bfloat16)) * kTStages *
                       (kTBM * kTALd + kTBK * kTBLd);

template <class Epi>
__global__ void __launch_bounds__(kTThreads)
gemm_bf16(const __nv_bfloat16* __restrict__ a,
          const __nv_bfloat16* __restrict__ b, int rows, int k_dim,
          int n_dim, int ldb, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto a_s = reinterpret_cast<__nv_bfloat16(*)[kTBM][kTALd]>(smem_raw);
  auto b_s = reinterpret_cast<__nv_bfloat16(*)[kTBK][kTBLd]>(
      smem_raw + sizeof(__nv_bfloat16) * kTStages * kTBM * kTALd);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTBM;
  const int n0 = blockIdx.y * kTBN;
  const int n_chunks = (k_dim + kTBK - 1) / kTBK;
  // loaders: K segment s (8 values) of A rows j and j + 64; B rows tid / 16
  // and 16 + tid / 16, 8 columns at (tid % 16) * 8
  const int s = (tid % 4) * 8;
  const int j = tid / 4;
  const int br = tid / 16;
  const int bc = (tid % 16) * 8;
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const int st = chunk % kTStages;
      const int k = chunk * kTBK + s;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + j + 64 * h;
        const bool ok = row < rows && k < k_dim;
        sm90::cp_async16(&a_s[st][j + 64 * h][s],
                         ok ? a + row * k_dim + k : a, ok ? 16 : 0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = chunk * kTBK + br + 16 * h;
        const bool ok = kr < k_dim && n0 + bc < n_dim;
        sm90::cp_async16(
            &b_s[st][br + 16 * h][bc],
            ok ? b + static_cast<long long>(kr) * ldb + n0 + bc : b,
            ok ? 16 : 0);
      }
    }
    sm90::cp_async_commit();  // an empty group past the end keeps the count
  };

  const int wm = (warp / 4) * 64;  // the warp's 64 rows x 32 columns
  const int wn = (warp % 4) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  load(0);
  load(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();
    __syncthreads();
    load(chunk + 2);
    const int st = chunk % kTStages;
#pragma unroll
    for (int ks = 0; ks < kTBK; ks += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        sm90::ldmatrix_x4(
            af[mt], &a_s[st][wm + mt * 16 + lane % 16][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        sm90::ldmatrix_x4_trans(
            bf[np], &b_s[st][ks + lane % 8 + ((lane / 8) % 2) * 8]
                        [wn + np * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sm90::mma_bf16(acc[mt][nt], af[mt], bf[nt / 2][(nt % 2) * 2],
                         bf[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  sm90::cp_async_wait<0>();

  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + mt * 16 + g + h * 8;
        const int col = n0 + wn + nt * 8 + t * 2;  // N % 8 == 0: col+1 too
        if (row < rows && col < n_dim) {
          const float v[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
          epi(row, col, v);
        }
      }
}

// One recompute GEMM on ``stream``: CUDA cores for float32, tensor cores
// for bfloat16. Returns 0 or a cudaError_t value.
template <class Epi>
int gemm(const float* a, const float* b, int rows, int k_dim, int n_dim,
         int ldb, Epi epi, cudaStream_t stream) {
  const dim3 grid((rows + kFBM - 1) / kFBM, (n_dim + kFBN - 1) / kFBN);
  gemm_f32<Epi><<<grid, kFThreads, 0, stream>>>(a, b, rows, k_dim, n_dim,
                                                 ldb, epi);
  return static_cast<int>(cudaGetLastError());
}

template <class Epi>
int gemm(const __nv_bfloat16* a, const __nv_bfloat16* b, int rows, int k_dim,
         int n_dim, int ldb, Epi epi, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory: the limit is raised before
  // every launch (a call that costs microseconds on the host)
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((rows + kTBM - 1) / kTBM, (n_dim + kTBN - 1) / kTBN);
  gemm_bf16<Epi><<<grid, kTThreads, kTSmem, stream>>>(a, b, rows, k_dim,
                                                       n_dim, ldb, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace seqre
