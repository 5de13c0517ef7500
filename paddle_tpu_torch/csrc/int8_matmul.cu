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
// Design: a block owns a tile of 64 rows x 64 columns of y and walks K in
// chunks of 32. For each chunk
//   - every thread loads 8 elements of the x chunk, a warp reading 32
//     consecutive k of one row (coalesced, predicated on M and K), widens
//     them to float32 and stores them k-major to shared memory (padded
//     rows: no bank conflicts on the transposed store);
//   - threads 0..127 each load 16 consecutive int8 weights of one k row:
//     one 16-byte load where N and the row start allow it (N % 16 == 0),
//     else two 8-byte loads (N % 8 == 0), else byte loads predicated on N
//     (lstm_out has N = 2, ResNet-50's fc N = 1000); each is dequantized
//     in registers with its column's scale (held in registers for the
//     whole K loop), rounded to x's dtype and stored as float32.
// The chunk is double-buffered in shared memory: the next chunk's global
// loads are in flight while this one is used, one barrier per chunk. Each
// thread accumulates a 4 x 4 register micro-tile with f32 FMA on the CUDA
// cores, in a fixed order: the result is deterministic (no split-K, no
// atomics). The TPU kernel's grid of 128-wide column blocks, its N % 128
// condition and its VMEM budget have no counterpart: any M, K, N >= 1.
//
// What bounds it on this card: at the served shapes (the flagship's
// transforms at bucket 32, M = 2048, K = 128 or 256, N = 1024) the work is
// 2*M*K*N operations on about 1-3 MB of operands, so the arithmetic rate
// bounds it (67 TFLOP/s in float32 on the CUDA cores, 989 in bfloat16 on
// the tensor cores). At M = 1 or 32 (ResNet-50's fc, a 2 MB int8 weight)
// the bytes of w_q bound it. This first kernel runs the CUDA cores in
// float32 for both dtypes; wgmma for bfloat16 and a split of K across
// blocks for small M (with a deterministic second pass) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // rows of y per block
constexpr int kBN = 64;   // columns of y per block
constexpr int kBK = 32;   // K chunk
constexpr int kThreads = 256;
constexpr int kXPerThread = kBM * kBK / kThreads;  // 8
constexpr int kWBytes = 16;                        // int8 weights per loader
constexpr int kWLoaders = kBK * kBN / kWBytes;     // 128 threads

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ y, int m,
                   int k, int n, int w_vec) {
  __shared__ float x_s[2][kBK][kBM + 1];             // [k][row], padded
  __shared__ __align__(16) float w_s[2][kBK][kBN];   // [k][column]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_chunks = (k + kBK - 1) / kBK;

  // the weight loader's row of the chunk and its 16 columns, whose scales
  // stay in registers for the whole K loop
  const bool w_loader = tid < kWLoaders;
  const int w_row = tid / (kBN / kWBytes);
  const int w_col = (tid % (kBN / kWBytes)) * kWBytes;
  float s[kWBytes];
#pragma unroll
  for (int j = 0; j < kWBytes; ++j) {
    const int col = n0 + w_col + j;
    s[j] = (w_loader && col < n) ? __ldg(scale + col) : 0.f;
  }

  float x_reg[kXPerThread];
  __align__(16) int8_t w_reg[kWBytes];
  auto fetch = [&](int chunk) {
    const int k0 = chunk * kBK;
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kThreads;
      const int row = m0 + idx / kBK;
      const int kk = k0 + idx % kBK;
      x_reg[i] = (row < m && kk < k)
                     ? to_float(x[static_cast<long long>(row) * k + kk])
                     : 0.f;
    }
    if (!w_loader) return;
    const int kk = k0 + w_row;
    const int col = n0 + w_col;
    const int8_t* src = w + static_cast<long long>(kk) * n + col;
    if (kk < k && col + kWBytes <= n && w_vec == 16) {
      *reinterpret_cast<int4*>(w_reg) =
          __ldg(reinterpret_cast<const int4*>(src));
    } else if (kk < k && col + kWBytes <= n && w_vec == 8) {
      reinterpret_cast<int2*>(w_reg)[0] =
          __ldg(reinterpret_cast<const int2*>(src));
      reinterpret_cast<int2*>(w_reg)[1] =
          __ldg(reinterpret_cast<const int2*>(src) + 1);
    } else {
#pragma unroll
      for (int j = 0; j < kWBytes; ++j) {
        w_reg[j] = (kk < k && col + j < n) ? src[j] : int8_t(0);
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kThreads;
      x_s[buf][idx % kBK][idx / kBK] = x_reg[i];
    }
    if (!w_loader) return;
#pragma unroll
    for (int j = 0; j < kWBytes; j += 4) {
      float4 v;
      v.x = round_to<T>(static_cast<float>(w_reg[j]) * s[j]);
      v.y = round_to<T>(static_cast<float>(w_reg[j + 1]) * s[j + 1]);
      v.z = round_to<T>(static_cast<float>(w_reg[j + 2]) * s[j + 2]);
      v.w = round_to<T>(static_cast<float>(w_reg[j + 3]) * s[j + 3]);
      *reinterpret_cast<float4*>(&w_s[buf][w_row][w_col + j]) = v;
    }
  };

  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3 of the tile
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) fetch(chunk + 1);
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_s[buf][kk][ty * 4 + i];
      const float4 b = *reinterpret_cast<const float4*>(&w_s[buf][kk][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (chunk + 1 < n_chunks) stage(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) {
        store_out(y + static_cast<long long>(row) * n + col, acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, int m,
           int k, int n, cudaStream_t stream, int* info) {
  const long long m_tiles = (static_cast<long long>(m) + kBM - 1) / kBM;
  if (m_tiles > 65535) return kErrTooLarge;
  // vector width of the weight loads: every row start is 16 (8) bytes
  // aligned when the base is and N is a multiple of 16 (8)
  const uintptr_t base = reinterpret_cast<uintptr_t>(w);
  const int w_vec = (n % 16 == 0 && base % 16 == 0)  ? 16
                    : (n % 8 == 0 && base % 8 == 0) ? 8
                                                    : 1;
  const dim3 grid((n + kBN - 1) / kBN, static_cast<unsigned>(m_tiles));
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), m, k, n, w_vec);
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = w_vec;
  info[3] = kBK;
  info[4] = static_cast<int>(sizeof(float) * 2 * kBK * (kBM + 1 + kBN));
  info[5] = 1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). x [m, k], w [k, n] int8,
// scale [n] float32, y [m, n]; all contiguous. info receives {column tiles,
// row tiles, weight load width in bytes, K chunk, static shared memory
// bytes, launches made}. Returns 0, a cudaError_t value, or a negative code
// above.
int int8_matmul(int dtype, const void* x, const void* w, const void* scale,
                void* y, int m, int k, int n, int device, void* stream,
                int* info) {
  if (m < 1 || k < 1 || n < 1) return kErrBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, y, m, k, n, s, info);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, scale, y, m, k, n, s, info);
  }
  return kErrBadArgument;
}

const char* int8_matmul_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code or an empty shape)";
    case kErrTooLarge:
      return "more than 65535 tiles of 64 rows";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
