// Stride-1 SAME convolution (odd square kernel, k in {1, 3}) for Hopper
// (sm_90a), NHWC x HWIO -> NHWC.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py
//   _conv_fwd_kernel  (:175, called by _fwd_impl :196, "K7")
// and, like it, also computes the data gradient: the transpose of a
// stride-1 SAME conv is the same conv with the spatially flipped,
// in/out-transposed weight w[::-1, ::-1].transpose(C, F)
// (pallas_conv.py:300-301), which the caller forms outside the kernel.
//
// Function:
//   y[n,h,w,f] = sum_{dh,dw,c} x[n, h+dh-k/2, w+dw-k/2, c] * w[dh,dw,c,f]
// with positions outside the image counted as zero. x and w are both
// float32 or both bfloat16; every product is summed in float32 and the
// result is rounded once to x's dtype.
//
// Design: an implicit GEMM, Y[M, F] = Z[M, K] . W[K, F], with M = N*H*W
// output positions, K = k*k*C in (tap, channel) order -- exactly W's HWIO
// memory order, so W is a plain row-major [K, F] matrix -- and Z never
// materialised. A block owns a tile of 128 positions x 64 filters and
// walks K in chunks of 8 channels of one tap (C is a multiple of 8, so a
// chunk never straddles a tap). For each chunk
//   - threads 0..127 each gather the 8 channels of one position's shifted
//     source pixel straight from NHWC x (two 16-byte loads in float32, one
//     in bfloat16; the image border is a predicate, not a padded copy),
//   - threads 128..255 each load 4 consecutive filters of one K row of W,
// widen to float32 and store the chunk to shared memory (double-buffered:
// the next chunk's global loads are in flight while this one is used, one
// barrier per chunk). Each thread then accumulates an 8 x 4 register
// micro-tile with FMA on the CUDA cores. The 128-lane packing, the padded
// copy of x and the VMEM budget of the TPU kernel have no counterpart here.
//
// What bounds it on this card: at the ResNet-50 shapes the work is 2*M*K*F
// operations on 2-17 MB of operands, far above the card's ratio of
// operations to bytes, so the bound is the arithmetic rate. This first
// kernel runs on the CUDA cores in float32 (67 TFLOP/s peak) also for
// bfloat16, whose bound is the tensor cores' 989 TFLOP/s; wgmma with TMA
// loads is the way to that rate and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output positions per block
constexpr int kBN = 64;   // filters per block
constexpr int kBK = 8;    // K chunk: 8 channels of one tap
constexpr int kThreads = 256;

// error codes beside cudaError_t values (which are all >= 0)
constexpr int kErrBadArgument = -1;
constexpr int kErrTooLarge = -2;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ y, int n_img, int height, int width, int cin,
                int cout, int ksize) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];  // [k][position]
  __shared__ __align__(16) float b_s[2][kBK][kBN];  // [k][filter]

  const int tid = threadIdx.x;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int f0 = blockIdx.x * kBN;
  const int pad = ksize / 2;
  const int n_chunks = ksize * ksize * cin / kBK;

  // loaders: threads [0, kBM) gather Z rows, the others load W rows
  const bool a_loader = tid < kBM;
  int pn = 0, ph = 0, pw = 0;
  bool m_ok = false;
  if (a_loader) {
    const long long m = m0 + tid;
    m_ok = m < m_total;
    if (m_ok) {
      pw = static_cast<int>(m % width);
      const long long t = m / width;
      ph = static_cast<int>(t % height);
      pn = static_cast<int>(t / height);
    }
  }
  int tap_h = 0, tap_w = 0, c0 = 0;  // tap and channel offset of the chunk
  const int b_row = (tid - kBM) / 16;
  const int b_col = ((tid - kBM) % 16) * 4;
  const bool b_ok = !a_loader && f0 + b_col < cout;

  float reg[8];
  auto fetch = [&](int chunk) {
    if (a_loader) {
      const int ih = ph + tap_h - pad;
      const int iw = pw + tap_w - pad;
      if (m_ok && ih >= 0 && ih < height && iw >= 0 && iw < width) {
        load8(x + ((static_cast<long long>(pn) * height + ih) * width + iw)
                      * cin + c0, reg);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) reg[i] = 0.f;
      }
      c0 += kBK;
      if (c0 == cin) {
        c0 = 0;
        if (++tap_w == ksize) {
          tap_w = 0;
          ++tap_h;
        }
      }
    } else if (b_ok) {
      load4(w + (static_cast<long long>(chunk) * kBK + b_row) * cout + f0
                + b_col, reg);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) reg[i] = 0.f;
    }
  };
  auto stage = [&](int buf) {
    if (a_loader) {
#pragma unroll
      for (int i = 0; i < kBK; ++i) a_s[buf][i][tid] = reg[i];
    } else {
      *reinterpret_cast<float4*>(&b_s[buf][b_row][b_col]) =
          make_float4(reg[0], reg[1], reg[2], reg[3]);
    }
  };

  const int ty = tid / 16;  // rows ty*8 .. ty*8+7 of the tile
  const int tx = tid % 16;  // filters tx*4 .. tx*4+3 of the tile
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  fetch(0);
  stage(0);
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) fetch(chunk + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[buf][k][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (chunk + 1 < n_chunks) stage(buf ^ 1);
    __syncthreads();
  }

  const int fo = f0 + tx * 4;  // cout % 8 == 0: the 4 filters are all in
  if (fo >= cout) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long mo = m0 + ty * 8 + i;
    if (mo < m_total) store4(y + mo * cout + fo, acc[i]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int n_img, int height,
           int width, int cin, int cout, int ksize, cudaStream_t stream,
           int* info) {
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m_tiles = (m_total + kBM - 1) / kBM;
  if (m_tiles > 65535) return kErrTooLarge;
  const dim3 grid((cout + kBN - 1) / kBN, static_cast<unsigned>(m_tiles));
  conv_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      n_img, height, width, cin, cout, ksize);
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = kBM;
  info[3] = kBN;
  info[4] = static_cast<int>(sizeof(float) * 2 * kBK * (kBM + kBN));
  info[5] = 1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y). x [n, height, width, cin]
// NHWC, w [ksize, ksize, cin, cout] HWIO, y [n, height, width, cout]; all
// contiguous, x 16-byte aligned. info receives {filter tiles, position
// tiles, positions per tile, filters per tile, static shared memory bytes,
// launches made}. Returns 0, a cudaError_t value, or a negative code above.
int conv2d_same_fwd(int dtype, const void* x, const void* w, void* y,
                    int n_img, int height, int width, int cin, int cout,
                    int ksize, int device, void* stream, int* info) {
  if (n_img < 1 || height < 1 || width < 1 || cin < kBK || cout < 8 ||
      cin % kBK != 0 || cout % 8 != 0 || (ksize != 1 && ksize != 3)) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, w, y, n_img, height, width, cin, cout, ksize, s,
                         info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, w, y, n_img, height, width, cin, cout,
                                 ksize, s, info);
  }
  return kErrBadArgument;
}

const char* conv2d_same_fwd_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code, an empty shape, C or F not a "
             "multiple of 8, or k not 1 or 3)";
    case kErrTooLarge:
      return "more than 65535 tiles of 128 output positions";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
