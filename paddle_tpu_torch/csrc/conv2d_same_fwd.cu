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
// materialised. A block owns a tile of 128 (or 64) positions x 64 (or 128)
// filters and walks K in chunks. Both operand tiles arrive by 16-byte
// cp.async through a 3-stage ring: the Z tile position-major (Z[p][k]),
// gathered straight from NHWC x -- a border tap is a zero-fill (src-size
// 0), so x needs no padded copy; C % 8 == 0 keeps every 16-byte copy
// inside one tap, also at C = 8, where a copy is a whole tap -- and the W
// tile k-major (W[k][f], its rows as they lie in memory). Each loader
// thread decodes its positions' (n, h, w) once and walks its (tap,
// channel) forward chunk by chunk with a compare and an add, no division.
// Two paths, picked by dtype (the caller's planner, ops/conv_kernels
// .fwd_plan, names the path and the tile):
//   bfloat16  tensor cores: 256 threads, chunks of 32 K values; ldmatrix
//             gives the A fragments (Z rows) and ldmatrix.trans the B
//             fragments (W's k-major rows) of mma.sync.m16n8k16 bf16 with
//             float32 accumulators. 128 x 128 tiles (8 warps of 64 x 32)
//             where F >= 128 and the grid still has two blocks per SM, else
//             128 x 64 (8 warps of 32 x 32). Rows padded by 16 bytes (80-
//             and 144/272-byte pitches) so that ldmatrix is conflict-free.
//             bf16 products are exact in float32: the result is rounded
//             once, as the TPU body does, and leaves through shared memory
//             in coalesced 16-byte rows (the 1x1 convs are bound by bytes).
//   float32   CUDA cores (the function's products are full float32; TF32
//             stays off): 128 threads, chunks of 16 K values, each thread
//             an 8 x 8 (or 4 x 8 in 64-position tiles) micro-tile: 4 shared
//             loads per 64 FMA. 64-position tiles where 128 would leave an
//             SM fewer than four blocks.
// No split of K, no atomics: a repeat is the same bit for bit.
//
// What bounds it on this card: at the ResNet-50 shapes the work is 2*M*K*F
// operations on 2-17 MB of operands, far above the card's ratio of
// operations to bytes, so the bound is the arithmetic rate (989 TFLOP/s
// bf16 on the tensor cores, 67 float32 on the CUDA cores). wgmma with TMA
// im2col loads is the next step for the bf16 path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "sm90_mma.cuh"

namespace {

constexpr int kPathTensorBf16 = 1;
constexpr int kPathFloat32 = 2;

constexpr int kStages = 3;

constexpr int kTcBM = 128;  // positions per block, tensor-core path
constexpr int kTcBK = 32;   // K values per chunk
constexpr int kTcThreads = 256;
constexpr int kTcZLd = kTcBK + 8;  // 80-byte rows: ldmatrix conflict-free

constexpr int kF32BN = 64;  // filters per block, CUDA-core path
constexpr int kF32BK = 16;
constexpr int kF32Threads = 128;
constexpr int kF32ZLd = kF32BK + 4;  // 80-byte rows, 16-byte aligned

// error codes beside cudaError_t values (which are all >= 0)
constexpr int kErrBadArgument = -1;
constexpr int kErrTooLarge = -2;

// An output position a loader thread copies, decoded once. In NHWC the
// position index m is also the pixel's index, so only (h, w) are kept for
// the border.
struct Pixel {
  long long m;
  int h, w;
  bool ok;

  __device__ __forceinline__ void decode(long long m_, long long m_total,
                                         int height, int width) {
    m = m_;
    ok = m_ < m_total;
    const long long mm = ok ? m_ : 0;
    w = static_cast<int>(mm % width);
    h = static_cast<int>((mm / width) % height);
  }
};

// The (tap, channel) of a loader thread's K segment, walked forward chunk
// by chunk: dh, dw are the tap's offsets (-k/2 .. k/2), c its channel.
struct Tap {
  int tap, dh, dw, c;

  __device__ __forceinline__ void start(int k0, int cin, int ksize) {
    tap = k0 / cin;
    c = k0 - tap * cin;
    dh = tap / ksize - ksize / 2;
    dw = tap % ksize - ksize / 2;
  }

  __device__ __forceinline__ void advance(int step, int cin, int ksize) {
    c += step;
    while (c >= cin) {
      c -= cin;
      ++tap;
      if (++dw > ksize / 2) {
        dw = -(ksize / 2);
        ++dh;
      }
    }
  }
};

// One 16-byte segment of the Z tile: the channels c.. of pixel p shifted by
// the tap; zeros past K, past M and outside the image (src-size 0).
template <typename T>
__device__ __forceinline__ void copy_z(T* dst, const T* __restrict__ x,
                                       const Pixel& p, const Tap& t,
                                       int taps, int cin, int height,
                                       int width) {
  const int ih = p.h + t.dh;
  const int iw = p.w + t.dw;
  const bool ok = p.ok && t.tap < taps && ih >= 0 && ih < height &&
                  iw >= 0 && iw < width;
  sm90::cp_async16(
      dst,
      ok ? x + (p.m + static_cast<long long>(t.dh) * width + t.dw) * cin + t.c
         : x,
      ok ? 16 : 0);
}

// One 16-byte segment of the W tile: filters f.. of K row r.
template <typename T>
__device__ __forceinline__ void copy_w(T* dst, const T* __restrict__ w, int r,
                                       int rows, int f, int cout) {
  const bool ok = r < rows && f < cout;
  sm90::cp_async16(dst, ok ? w + static_cast<long long>(r) * cout + f : w,
                   ok ? 16 : 0);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. BN = 128 or 64 filters per block.

template <int BN>
__host__ __device__ constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(__nv_bfloat16)) * kStages *
         (kTcBM * kTcZLd + kTcBK * (BN + 8));
}

template <int BN>
__global__ void __launch_bounds__(kTcThreads)
conv_fwd_tc_bf16(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, int n_img, int height,
                 int width, int cin, int cout, int ksize) {
  constexpr int kWLd = BN + 8;        // 144- or 272-byte rows: conflict-free
  constexpr int kWarpsN = BN / 32;    // warps across the filters
  constexpr int kWM = kTcBM / (8 / kWarpsN);  // rows of a warp: 64 or 32
  constexpr int kMT = kWM / 16;       // m16 tiles of a warp
  constexpr int kWSegs = BN / 8;      // 16-byte segments of a W row
  static_assert(sizeof(__nv_bfloat16) * kTcBM * kWLd <= tc_smem_bytes<BN>(),
                "the output tile fits in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  auto z_s = reinterpret_cast<__nv_bfloat16(*)[kTcBM][kTcZLd]>(smem);
  auto w_s = reinterpret_cast<__nv_bfloat16(*)[kTcBK][kWLd]>(
      smem + sizeof(__nv_bfloat16) * kStages * kTcBM * kTcZLd);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m0 = static_cast<long long>(blockIdx.y) * kTcBM;
  const int f0 = blockIdx.x * BN;
  const int taps = ksize * ksize;
  const int rows = taps * cin;
  const int n_chunks = (rows + kTcBK - 1) / kTcBK;

  // loader: K segment s (8 values) of positions j and j + 64; W rows
  // wr + (256 / kWSegs) * i, segment wc
  const int s = tid % 4;
  const int j = tid / 4;
  Pixel pa, pb;
  pa.decode(m0 + j, m_total, height, width);
  pb.decode(m0 + j + 64, m_total, height, width);
  Tap tap;
  tap.start(s * 8, cin, ksize);
  const int wr = tid / kWSegs;
  const int wc = (tid % kWSegs) * 8;
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const int st = chunk % kStages;
      copy_z(&z_s[st][j][s * 8], x, pa, tap, taps, cin, height, width);
      copy_z(&z_s[st][j + 64][s * 8], x, pb, tap, taps, cin, height, width);
      tap.advance(kTcBK, cin, ksize);
#pragma unroll
      for (int i = 0; i < kTcBK * kWSegs / kTcThreads; ++i) {
        const int r = wr + (kTcThreads / kWSegs) * i;
        copy_w(&w_s[st][r][wc], w, chunk * kTcBK + r, rows, f0 + wc, cout);
      }
    }
    sm90::cp_async_commit();  // an empty group past the end keeps the count
  };

  const int wm = (warp / kWarpsN) * kWM;  // the warp's kWM rows x 32 filters
  const int wn = (warp % kWarpsN) * 32;
  float acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;

  load(0);
  load(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();  // this chunk has landed
    __syncthreads();           // ... for every thread; chunk-1 is consumed
    load(chunk + 2);
    const int st = chunk % kStages;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      uint32_t a[kMT][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        sm90::ldmatrix_x4(
            a[mt], &z_s[st][wm + mt * 16 + lane % 16][ks + (lane / 16) * 8]);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        sm90::ldmatrix_x4_trans(
            b[np], &w_s[st][ks + lane % 8 + ((lane / 8) % 2) * 8]
                       [wn + np * 16 + (lane / 16) * 8]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          sm90::mma_bf16(acc[mt][nt], a[mt], b[nt / 2][(nt % 2) * 2],
                         b[nt / 2][(nt % 2) * 2 + 1]);
    }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile next

  // the tile, rounded once to bfloat16, through shared memory (rows padded
  // by 16 bytes: conflict-free), then out in coalesced 16-byte rows
  auto y_s = reinterpret_cast<__nv_bfloat16(*)[kWLd]>(smem);
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(
            &y_s[wm + mt * 16 + g + h * 8][wn + nt * 8 + t * 2]) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();
  for (int e = tid; e < kTcBM * kWSegs; e += kTcThreads) {
    const int r = e / kWSegs;
    const int c = (e % kWSegs) * 8;
    const long long m = m0 + r;
    if (m < m_total && f0 + c < cout) {  // cout % 8 == 0: all 8 or none
      *reinterpret_cast<uint4*>(y + m * cout + f0 + c) =
          *reinterpret_cast<const uint4*>(&y_s[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores. BM = 128 or 64 positions per block, 64 filters.

template <int BM>
constexpr int f32_smem_bytes() {
  return static_cast<int>(sizeof(float)) * kStages *
         (BM * kF32ZLd + kF32BK * kF32BN);
}

template <int BM>
__global__ void __launch_bounds__(kF32Threads)
conv_fwd_simt_f32(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int n_img, int height, int width,
                  int cin, int cout, int ksize) {
  constexpr int kRowsPerThread = BM / 32;  // Z rows a loader copies
  constexpr int kMI = BM / 16;             // micro-tile rows
  __shared__ __align__(16) float z_s[kStages][BM][kF32ZLd];
  __shared__ __align__(16) float w_s[kStages][kF32BK][kF32BN];

  const int tid = threadIdx.x;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int f0 = blockIdx.x * kF32BN;
  const int taps = ksize * ksize;
  const int rows = taps * cin;
  const int n_chunks = (rows + kF32BK - 1) / kF32BK;

  // loader: K segment s (4 values) of positions j + 32 i; W rows
  // tid / 16 + 8 i, segment (tid % 16) * 4
  const int s = tid % 4;
  const int j = tid / 4;
  Pixel px[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    px[i].decode(m0 + j + 32 * i, m_total, height, width);
  }
  Tap tap;
  tap.start(s * 4, cin, ksize);
  const int wr = tid / 16;
  const int wc = (tid % 16) * 4;
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const int st = chunk % kStages;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        copy_z(&z_s[st][j + 32 * i][s * 4], x, px[i], tap, taps, cin, height,
               width);
      }
      tap.advance(kF32BK, cin, ksize);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wr + 8 * i;
        copy_w(&w_s[st][r][wc], w, chunk * kF32BK + r, rows, f0 + wc, cout);
      }
    }
    sm90::cp_async_commit();
  };

  // rows ty + 16 i, filters tx*4 + {0..3} and 32 + tx*4 + {0..3}: a warp's
  // row reads land in 4 distinct banks (80-byte pitch), its filter reads are
  // contiguous
  const int tx = tid % 8;
  const int ty = tid / 8;
  float acc[kMI][8];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[i][t] = 0.f;

  load(0);
  load(1);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    sm90::cp_async_wait<1>();
    __syncthreads();
    load(chunk + 2);
    const int st = chunk % kStages;
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      float a[kMI];
#pragma unroll
      for (int i = 0; i < kMI; ++i) a[i] = z_s[st][ty + 16 * i][kk];
      const float4 b0 = *reinterpret_cast<const float4*>(&w_s[st][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&w_s[st][kk][32 + tx * 4]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= m_total) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = f0 + half * 32 + tx * 4;  // cout % 8 == 0: all 4 or none
      if (f < cout) {
        *reinterpret_cast<float4*>(y + m * cout + f) =
            make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                        acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
      }
    }
  }
}

// The 128-filter tensor-core kernel needs more than 48 KB of dynamic shared
// memory: its limit is raised once per device (one shape per kernel).
std::mutex smem_mutex;
bool smem_set[64];

cudaError_t raise_smem_limit(int device) {
  std::lock_guard<std::mutex> lock(smem_mutex);
  if (device >= 0 && device < 64 && smem_set[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_fwd_tc_bf16<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes<128>());
  if (err == cudaSuccess && device >= 0 && device < 64) {
    smem_set[device] = true;
  }
  return err;
}

int launch(int dtype, const void* x, const void* w, void* y, int n_img,
           int height, int width, int cin, int cout, int ksize, int path,
           int filters_per_tile, int positions_per_tile, int device,
           cudaStream_t stream, int* info) {
  if ((path != kPathTensorBf16 && path != kPathFloat32) ||
      (path == kPathTensorBf16) != (dtype == 1)) {
    return kErrBadArgument;
  }
  if (path == kPathTensorBf16
          ? positions_per_tile != kTcBM ||
                (filters_per_tile != 64 && filters_per_tile != 128)
          : filters_per_tile != kF32BN ||
                (positions_per_tile != 64 && positions_per_tile != 128)) {
    return kErrBadArgument;
  }
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m_tiles =
      (m_total + positions_per_tile - 1) / positions_per_tile;
  if (m_tiles > 65535) return kErrTooLarge;
  const dim3 grid((cout + filters_per_tile - 1) / filters_per_tile,
                  static_cast<unsigned>(m_tiles));
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaError_t err = cudaSuccess;
  int smem = 0;
  if (path == kPathTensorBf16 && filters_per_tile == 128) {
    smem = tc_smem_bytes<128>();
    err = raise_smem_limit(device);
    if (err == cudaSuccess) {
      conv_fwd_tc_bf16<128><<<grid, kTcThreads, smem, stream>>>(
          xb, wb, yb, n_img, height, width, cin, cout, ksize);
    }
  } else if (path == kPathTensorBf16) {
    smem = tc_smem_bytes<64>();
    conv_fwd_tc_bf16<64><<<grid, kTcThreads, smem, stream>>>(
        xb, wb, yb, n_img, height, width, cin, cout, ksize);
  } else if (positions_per_tile == 128) {
    smem = f32_smem_bytes<128>();
    conv_fwd_simt_f32<128><<<grid, kF32Threads, 0, stream>>>(
        xf, wf, yf, n_img, height, width, cin, cout, ksize);
  } else {
    smem = f32_smem_bytes<64>();
    conv_fwd_simt_f32<64><<<grid, kF32Threads, 0, stream>>>(
        xf, wf, yf, n_img, height, width, cin, cout, ksize);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = positions_per_tile;
  info[3] = filters_per_tile;
  info[4] = smem;
  info[5] = 1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y). x [n, height, width, cin]
// NHWC, w [ksize, ksize, cin, cout] HWIO, y [n, height, width, cout]; all
// contiguous and 16-byte aligned. path 1 = tensor cores (bfloat16; 128
// positions x 64 or 128 filters per tile), 2 = CUDA cores (float32; 128 or
// 64 positions x 64 filters). info receives {filter tiles, position tiles,
// positions per tile, filters per tile, shared memory bytes, launches
// made}. Returns 0, a cudaError_t value, or a negative code above.
int conv2d_same_fwd(int dtype, const void* x, const void* w, void* y,
                    int n_img, int height, int width, int cin, int cout,
                    int ksize, int path, int filters_per_tile,
                    int positions_per_tile, int device, void* stream,
                    int* info) {
  if (n_img < 1 || height < 1 || width < 1 || cin < 8 || cout < 8 ||
      cin % 8 != 0 || cout % 8 != 0 || (ksize != 1 && ksize != 3) ||
      (dtype != 0 && dtype != 1)) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(dtype, x, w, y, n_img, height, width, cin, cout, ksize, path,
                filters_per_tile, positions_per_tile, device,
                static_cast<cudaStream_t>(stream), info);
}

const char* conv2d_same_fwd_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code, an empty shape, C or F not a "
             "multiple of 8, k not 1 or 3, or a tile the path does not take)";
    case kErrTooLarge:
      return "more than 65535 position tiles";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
