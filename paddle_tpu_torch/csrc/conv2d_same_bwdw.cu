// Filter gradient of the stride-1 SAME convolution (odd square kernel,
// k in {1, 3}) for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py
//   _conv_bwdw_kernel  (:226, called by _bwd_filter_impl :252, "K8")
//
// Function (x [N, H, W, C] NHWC, dy [N, H, W, F], both float32 or both
// bfloat16):
//   dw[dh,dw,c,f] = sum_{n,h,w} x[n, h+dh-k/2, w+dw-k/2, c] * dy[n,h,w,f]
// with positions outside the image counted as zero, summed in float32 and
// returned float32 [k, k, C, F] (the caller casts it to w's dtype).
//
// Design: the GEMM dW[R, F] = Z^T[R, M] . dY[M, F] with R = k*k*C rows in
// (tap, channel) order (dW's HWIO memory order) and a reduction over the
// M = N*H*W positions, which is long (207,936 at ResNet-50's stage 2, batch
// 64) while the output is small (at most 4608 x 512). On the TPU the grid
// ran in order and carried the sum in the output block from one image to
// the next; blocks on this card run in no order, so M is split instead:
//   pass 1  block (filter tile, row tile, split s) sums its 128 rows x 64
//           filters over the s-th contiguous range of positions and writes
//           the float32 partial tile to workspace[s] (every entry, zeros
//           included);
//   pass 2  one thread per dW entry adds the S partials in the order
//           s = 0, 1, ..., S-1.
// No atomics, so the result is the same bit for bit from run to run. The
// split count S is chosen by the caller (about four blocks per SM in
// all, at least 256 positions per split) and sizes the workspace.
// Pass 1 walks its range in chunks of 8 positions: threads 0..127 each
// gather 8 channels (one row group) of one shifted source pixel straight
// from NHWC x -- the border is a predicate, not a padded copy -- and
// threads 128..255 each load 4 filters of one position of dY; both are
// widened to float32 and staged in shared memory (double-buffered, one
// barrier per chunk), and each thread accumulates an 8 x 4 register
// micro-tile with FMA on the CUDA cores.
//
// What bounds it on this card: 2*M*R*F operations on a few MB of operands,
// so the arithmetic rate, as for the forward (csrc/conv2d_same_fwd.cu);
// this first kernel uses the CUDA cores in float32 also for bfloat16
// inputs. The workspace round trip of pass 2 (S*R*F floats, at most about
// 20 MB at the ResNet-50 shapes) is small beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // dW rows (tap, channel) per block
constexpr int kBN = 64;   // filters per block
constexpr int kBK = 8;    // positions per chunk
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwdw_partial(const T* __restrict__ x, const T* __restrict__ dy,
                  float* __restrict__ ws, int n_img, int height, int width,
                  int cin, int cout, int ksize, long long per_split) {
  __shared__ __align__(16) float a_s[2][kBK][kBM];  // [position][row]
  __shared__ __align__(16) float b_s[2][kBK][kBN];  // [position][filter]

  const int tid = threadIdx.x;
  const int rows = ksize * ksize * cin;
  const int f0 = blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const long long m_begin = static_cast<long long>(blockIdx.z) * per_split;
  const long long m_end =
      m_begin + per_split < m_total ? m_begin + per_split : m_total;
  const int n_chunks =
      m_end > m_begin ? static_cast<int>((m_end - m_begin + kBK - 1) / kBK)
                      : 0;
  const int pad = ksize / 2;

  // loaders: threads [0, 128) gather Z (row group a_g, position slot a_j),
  // the others load dY (position slot b_j, filters b_col .. b_col+3)
  const bool a_loader = tid < 128;
  const int a_j = tid / 16;
  const int a_g = tid % 16;
  const int r = r0 + a_g * 8;
  const bool r_ok = a_loader && r < rows;
  const int tap = r_ok ? r / cin : 0;
  const int c = r_ok ? r % cin : 0;
  const int off_h = tap / ksize - pad;
  const int off_w = tap % ksize - pad;
  const int b_j = (tid - 128) / 16;
  const int b_col = ((tid - 128) % 16) * 4;
  const bool b_ok = !a_loader && f0 + b_col < cout;
  // the position this thread loads in the current chunk
  long long m = m_begin + (a_loader ? a_j : b_j);
  int pn = 0, ph = 0, pw = 0;
  if (a_loader && m < m_total) {
    pw = static_cast<int>(m % width);
    const long long t = m / width;
    ph = static_cast<int>(t % height);
    pn = static_cast<int>(t / height);
  }

  float reg[8];
  auto fetch = [&]() {
    if (a_loader) {
      const int ih = ph + off_h;
      const int iw = pw + off_w;
      if (r_ok && m < m_end && ih >= 0 && ih < height && iw >= 0 &&
          iw < width) {
        load8(x + ((static_cast<long long>(pn) * height + ih) * width + iw)
                      * cin + c, reg);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) reg[i] = 0.f;
      }
      pw += kBK;
      while (pw >= width) {
        pw -= width;
        if (++ph == height) {
          ph = 0;
          ++pn;
        }
      }
    } else if (b_ok && m < m_end) {
      load4(dy + m * cout + f0 + b_col, reg);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) reg[i] = 0.f;
    }
    m += kBK;
  };
  auto stage = [&](int buf) {
    if (a_loader) {
      *reinterpret_cast<float4*>(&a_s[buf][a_j][a_g * 8]) =
          make_float4(reg[0], reg[1], reg[2], reg[3]);
      *reinterpret_cast<float4*>(&a_s[buf][a_j][a_g * 8 + 4]) =
          make_float4(reg[4], reg[5], reg[6], reg[7]);
    } else {
      *reinterpret_cast<float4*>(&b_s[buf][b_j][b_col]) =
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

  if (n_chunks > 0) {
    fetch();
    stage(0);
  }
  __syncthreads();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) fetch();
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
  float* out = ws + static_cast<long long>(blockIdx.z) * rows * cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ro = r0 + ty * 8 + i;
    if (ro < rows) {
      *reinterpret_cast<float4*>(out + static_cast<long long>(ro) * cout +
                                 fo) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
conv_bwdw_reduce(const float* __restrict__ ws, float* __restrict__ dw,
                 long long count, int splits) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * count + i];
    dw[i] = s;
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* dw, void* ws, int n_img,
           int height, int width, int cin, int cout, int ksize, int splits,
           cudaStream_t stream, int* info) {
  const long long m_total = static_cast<long long>(n_img) * height * width;
  const int rows = ksize * ksize * cin;
  const long long per = (m_total + splits - 1) / splits;
  const long long per_split = (per + kBK - 1) / kBK * kBK;
  const dim3 grid((cout + kBN - 1) / kBN, (rows + kBM - 1) / kBM, splits);
  conv_bwdw_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(ws), n_img, height, width, cin, cout, ksize,
      per_split);
  cudaError_t err = cudaGetLastError();
  info[0] = static_cast<int>(grid.x);
  info[1] = static_cast<int>(grid.y);
  info[2] = splits;
  info[3] = static_cast<int>(per_split);
  info[4] = static_cast<int>(sizeof(float) * 2 * kBK * (kBM + kBN));
  info[5] = 1;
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = static_cast<long long>(rows) * cout;
  long long blocks = (count + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 4096) blocks = 4096;
  conv_bwdw_reduce<<<static_cast<unsigned>(blocks), kReduceThreads, 0,
                     stream>>>(static_cast<const float*>(ws),
                               static_cast<float*>(dw), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and dy); dw [ksize, ksize, cin, cout]
// and the workspace ws [splits, ksize*ksize*cin, cout] are float32. x
// [n, height, width, cin] NHWC, dy [n, height, width, cout]; all
// contiguous, x 16-byte aligned. info receives {filter tiles, row tiles,
// splits, positions per split, static shared memory bytes of pass 1,
// launches made (one per call: pass 1 and pass 2 together)}. Returns 0, a
// cudaError_t value, or a negative code above.
int conv2d_same_bwdw(int dtype, const void* x, const void* dy, void* dw,
                     void* ws, int n_img, int height, int width, int cin,
                     int cout, int ksize, int splits, int device,
                     void* stream, int* info) {
  if (n_img < 1 || height < 1 || width < 1 || cin < 8 || cout < 8 ||
      cin % 8 != 0 || cout % 8 != 0 || (ksize != 1 && ksize != 3) ||
      splits < 1) {
    return kErrBadArgument;
  }
  if (splits > 65535 || (ksize * ksize * cin + kBM - 1) / kBM > 65535) {
    return kErrTooLarge;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dy, dw, ws, n_img, height, width, cin, cout,
                         ksize, splits, s, info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dy, dw, ws, n_img, height, width, cin,
                                 cout, ksize, splits, s, info);
  }
  return kErrBadArgument;
}

const char* conv2d_same_bwdw_error_string(int code) {
  switch (code) {
    case kErrBadArgument:
      return "bad argument (dtype code, an empty shape, C or F not a "
             "multiple of 8, k not 1 or 3, or no split)";
    case kErrTooLarge:
      return "more than 65535 splits or row tiles";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
