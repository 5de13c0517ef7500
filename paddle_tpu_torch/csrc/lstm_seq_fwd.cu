// Whole-sequence masked peephole-LSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_kernels.py
//   _lstm_fwd_kernel        (:146, called by _lstm_fwd_resident, "K1")
//   _lstm_fwd_tiled_kernel  (:244, called by _lstm_fwd_tiled,    "K3")
// Both compute one function; "resident" and "tiled" exist only because of
// the TPU's on-chip memory budget, so they are one kernel here.
//
// Function (gate order i, f, g, o; gates_tm already holds x.W_in + b):
//   z   = gates_t + h_{t-1} . W_rec                (f32 accumulation)
//   i,f = sigmoid(z_{i,f} + c_{t-1} * peep_{i,f})
//   g   = tanh(z_g)
//   c_t = f * c_{t-1} + i * g                      (carried in f32)
//   o   = sigmoid(z_o + c_t * peep_o)
//   h_t = o * tanh(c_t)                            (stored in the input dtype)
// A masked step (mask[t, b] == 0) copies h and c forward. Outputs are the
// per-step h_seq and c_seq [T, B, H]; the final states are their last rows.
//
// The T steps are serially dependent: time is set by a step's latency (the
// exchange of h_t between the blocks that need it, a barrier, the K loop)
// and, at large H, by the step's B x H x 4H multiply-adds. Three layouts,
// picked by the caller's planner (ops/lstm_kernels.fwd_plan) from the
// shapes and dtype and recorded in info[2]. Every sum runs in a fixed
// order, without atomics: a repeat is the same bit for bit.
//
// CLUSTERS (K1: H % 8 == 0, at most 16 unit tiles; the flagship's H=256).
// Batch rows never exchange anything; only the units of one row do. So
// each batch tile of R rows is ONE thread-block cluster of ceil(H / 32)
// blocks, block j owning units 32j .. 32j + 31 (their four gate columns),
// and clusters never wait for each other (no cooperative launch). A block
// keeps its W columns on chip for the whole launch (fwd_cluster.cuh: in
// registers up to 8 blocks, else in shared memory) and, in its own shared
// memory, h_{t-1} of all units for its R rows (float32, double-buffered by
// step parity). Per step it forms z of its 128 columns for its R rows over
// the full K (float32 on the CUDA cores; bfloat16 on the tensor cores,
// mma.sync), applies the cell (warp r: row r, lane l: unit l), stores h_t
// into every peer's buffer of the next parity (distributed shared memory)
// and writes h_seq and c_seq, then crosses one cluster barrier
// (arrive.release; the next step's gates and mask are fetched; wait.acquire).
// One barrier a step is enough: a block stores into a peer's buffer of
// parity (t + 1) % 2 at step t, after the barrier of step t - 1, which the
// peer reaches only after reading that buffer at step t - 1. R (1, 2, 3,
// 4, 5 or 8) is the smallest that keeps the batch's clusters co-resident
// (lstm_seq_fwd_limits).
//
// GRID (K3: H >= 512 where the slice fits; the wide model's H=1280). W
// [H, 4H] is spread over the shared memory of ONE persistent cooperative
// grid of one block per SM: block j owns U units (U = ceil(H / SMs)
// rounded up to even, 10 at H=1280 on 132 SMs: 128 blocks) with their four
// gate columns, for ALL rows of the launch, loaded once per launch
// (float32 [K][4U]: 200 KB at H=1280; bfloat16 in mma.sync B-fragment
// order), and never reads W again. The h state lives in a global double
// buffer [2][H][64 P] (unit-major, so that a block writes its units' h_t
// as contiguous runs). Per step and pass of 64 rows (P = 1 or 2 passes: up
// to 128 rows per launch), the block streams h_{t-1} [64, H] from L2 in K
// chunks through a 3-stage cp.async ring (one block barrier per chunk) and
// accumulates its [64 x 4U] tile:
//   float32: CUDA cores in full float32, register tiles of 8 rows x 8
//     columns split over 8 K lanes (four 16-byte loads for 64 FMAs: 8 x 4
//     tiles made the loop shared-memory bound, 16 x 8 spilled; the staged
//     h rows XOR-swizzled, conflict-free), the lanes' sums reduce-
//     scattered by shuffles in fixed pairs;
//   bfloat16: tensor cores, mma.sync.m16n8k16 (A by ldmatrix.trans from the
//     k-major staged rows, B fragments from shared memory, a chunk's
//     fragments loaded before its products), the tile through shared
//     memory;
// then each lane applies the cell to its two rows of one unit, writes h_t
// (to the buffer and h_seq) and c_t, and the grid crosses one barrier; the
// next step's gates and mask are fetched after it, in the shadow of the K
// loop. This removes unit tiles' re-read of W from L2 once per batch tile
// per step (8 times at B=64): per step only h moves, once per block. A
// batch above 128 rows runs as equal row chunks, one launch each. Bound
// on this card: in float32 the step's 2 B H 4H FLOPs at the CUDA cores'
// rate (13.6 us a step at B=64, H=1280) with the h stream from L2 (42 MB a
// step) beside it; in bfloat16 the h stream, the barrier and the cells.
//
// UNIT TILES (what neither takes: H % 8 != 0 below 512, or a W slice that
// fits no block). ONE cooperative launch per sequence over a persistent
// grid. Block (unit tile, batch tile) owns 32 hidden units (one per lane) x
// R batch rows for the whole sequence; warp r keeps the c and h of row r's
// 32 cells in registers across all T steps. Per step a block
//   1. stages the full h_{t-1} rows of its batch tile into shared memory
//      (L2-only loads from a global double buffer [2, B, H] that other
//      blocks rewrote last step),
//   2. splits K = H over its 8 warps: each warp accumulates, in f32 on CUDA
//      cores, the four gate sums of the 32 units for all R rows over its
//      K slice, reading h as float4 shared-memory broadcasts and W_rec from
//      shared memory when the block's slice (H x 128 columns) fits there
//      ("resident", loaded once per launch), else from global memory/L2,
//   3. reduces the 8 partial sums through shared memory in a fixed order,
//      adds gates_t (prefetched during the previous step), applies the cell
//      math, writes h_t to the other buffer and to h_seq, prefetches
//      gates_{t+1}, and waits on a grid-wide barrier.
// The host picks R and the W placement so that the grid is co-resident (a
// cooperative launch refuses otherwise): resident W with the most blocks
// that fit, else W in L2 with the largest R (the least L2 traffic). Rows
// are independent, so a batch too large for one co-resident grid is split
// into the fewest equal chunks that fit, one launch per chunk in stream
// order (each launch reads and writes its rows at the full batch's pitch).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "fwd_cluster.cuh"
#include "sm90_cluster.cuh"
#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 32;         // hidden units per block: one per lane
constexpr int kCols = 4 * kUnits;  // W_rec columns per block (i, f, g, o)
constexpr int kWarps = 8;          // K is split over the warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKPad = 4;  // K is padded to a multiple of this (float4 reads)

// error codes beside cudaError_t values (which are all >= 0)
constexpr int kErrNotCoResident = -1;
constexpr int kErrNoCooperative = -2;
constexpr int kErrBadArgument = -3;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// read-only inputs (W_rec, gates): through the non-coherent cache
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// the h double buffer is rewritten by other blocks every step: read it
// from L2 (cache-global), never from a possibly stale L1 line
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr int w_smem_bytes(int kpad, int elem_bytes) {
  return round_up(kpad * kCols * elem_bytes, 16);
}

// W in L2: ask for 3 blocks per SM, so that a 64 x 1280 batch tile grid
// (320 blocks of R = 8) stays co-resident on 132 SMs
template <typename T, int R, bool kResident>
__global__ void __launch_bounds__(kThreads, kResident ? 1 : 3)
lstm_seq_fwd_kernel(const T* __restrict__ gates, const float* __restrict__ mask,
                    const T* __restrict__ w_rec, const float* __restrict__ peep,
                    const T* __restrict__ h0, const T* __restrict__ c0,
                    T* __restrict__ h_seq, T* __restrict__ c_seq, T* hbuf,
                    int steps, int batch, int stride, int hidden,
                    int unit_tiles) {
  // batch: the rows of this launch; stride: the rows of the whole batch,
  // the pitch of every [T, B, ...] and [2, B, H] array (the pointers start
  // at this launch's first row)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int kpad = round_up(hidden, kKPad);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = (blockIdx.x % unit_tiles) * kUnits;
  const int u = u0 + lane;
  const int b0 = (blockIdx.x / unit_tiles) * R;
  const bool u_ok = u < hidden;
  const int g4 = 4 * hidden;
  const size_t bh = static_cast<size_t>(stride) * hidden;
  // this warp's K slice
  const int ks = round_up((kpad + kWarps - 1) / kWarps, kKPad);
  const int k_begin = min(kpad, warp * ks);
  const int k_end = min(kpad, k_begin + ks);
  // this warp's own row (warp r owns row r of the tile)
  const int b = b0 + warp;
  const bool owner = warp < R && u_ok && b < batch;

  // shared memory: [W slice (resident only)] [h rows R x kpad]
  //                [partial sums kWarps x 4 x R x 32]
  T* ws = reinterpret_cast<T*>(smem_raw);
  float* hs = reinterpret_cast<float*>(
      smem_raw +
      (kResident ? w_smem_bytes(kpad, static_cast<int>(sizeof(T))) : 0));
  float* red = hs + R * kpad;
  if (kResident) {
    for (int e = threadIdx.x; e < kpad * kCols; e += kThreads) {
      const int k = e / kCols;
      const int j = e % kCols;
      const int uu = u0 + j % kUnits;
      ws[e] = (k < hidden && uu < hidden)
                  ? w_rec[static_cast<size_t>(k) * g4 + (j / kUnits) * hidden +
                          uu]
                  : from_f<T>(0.f);
    }
  }

  float pi = 0.f, pf = 0.f, po = 0.f, c = 0.f, h = 0.f;
  float zg[4] = {0.f, 0.f, 0.f, 0.f};
  if (owner) {
    pi = peep[u];
    pf = peep[hidden + u];
    po = peep[2 * hidden + u];
    const size_t o = static_cast<size_t>(b) * hidden + u;
    h = to_f(h0[o]);
    c = to_f(c0[o]);
    hbuf[o] = h0[o];
    const T* g = gates + static_cast<size_t>(b) * g4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) zg[q] = load_ro(g + q * hidden);
  }
  grid.sync();  // h0 in the buffer (and W resident) before step 0

  for (int t = 0; t < steps; ++t) {
    const T* hprev = hbuf + (t & 1) * bh;
    T* hnext = hbuf + ((t + 1) & 1) * bh;
    // 1. stage h_{t-1} rows of this batch tile (zero past H and past B)
    for (int e = threadIdx.x; e < R * kpad; e += kThreads) {
      const int row = e / kpad;
      const int k = e % kpad;
      const int bb = b0 + row;
      hs[e] = (bb < batch && k < hidden)
                  ? load_cg(hprev + static_cast<size_t>(bb) * hidden + k)
                  : 0.f;
    }
    __syncthreads();
    // 2. this warp's partial gate sums over its K slice
    float acc[4][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r] = acc[1][r] = acc[2][r] = acc[3][r] = 0.f;
    }
    if (u_ok) {
      for (int k = k_begin; k < k_end; k += 4) {
        float w[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (kResident) {
              w[kk][q] = to_f(ws[(k + kk) * kCols + q * kUnits + lane]);
            } else {
              w[kk][q] = k + kk < hidden
                             ? load_ro(w_rec + static_cast<size_t>(k + kk) * g4 +
                                       q * hidden + u)
                             : 0.f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + r * kpad + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][r] = fmaf(hv.x, w[0][q], acc[q][r]);
            acc[q][r] = fmaf(hv.y, w[1][q], acc[q][r]);
            acc[q][r] = fmaf(hv.z, w[2][q], acc[q][r]);
            acc[q][r] = fmaf(hv.w, w[3][q], acc[q][r]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        red[((warp * 4 + q) * R + r) * kUnits + lane] = acc[q][r];
      }
    }
    __syncthreads();
    // 3. owners reduce the partials (fixed order), cell math, h_t out
    if (owner) {
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s += red[((w * 4 + q) * R + warp) * kUnits + lane];
        }
        z[q] = zg[q] + s;
      }
      const size_t row = static_cast<size_t>(t) * stride + b;
      const float ig = sigmoidf(z[0] + c * pi);
      const float fg = sigmoidf(z[1] + c * pf);
      const float gg = tanhf(z[2]);
      const float cn = fg * c + ig * gg;
      const float og = sigmoidf(z[3] + cn * po);
      const float hn = og * tanhf(cn);
      if (mask[row] > 0.f) {
        c = cn;
        h = to_f(from_f<T>(hn));
      }
      const size_t o = row * hidden + u;
      const T hv = from_f<T>(h);
      h_seq[o] = hv;
      c_seq[o] = from_f<T>(c);
      hnext[static_cast<size_t>(b) * hidden + u] = hv;
      if (t + 1 < steps) {  // next step's gates, off the critical path
        const T* g = gates + (row + stride) * g4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) zg[q] = load_ro(g + q * hidden);
      }
    }
    grid.sync();  // h_t complete everywhere before any block reads it
  }
}

template <typename T, int R, bool kResident>
void* kernel_ptr() {
  return reinterpret_cast<void*>(lstm_seq_fwd_kernel<T, R, kResident>);
}

template <typename T>
void* pick_kernel(bool resident, int rows) {
  switch (rows) {
    case 1:
      return resident ? kernel_ptr<T, 1, true>() : kernel_ptr<T, 1, false>();
    case 2:
      return resident ? kernel_ptr<T, 2, true>() : kernel_ptr<T, 2, false>();
    case 4:
      return resident ? kernel_ptr<T, 4, true>() : kernel_ptr<T, 4, false>();
    default:
      return resident ? kernel_ptr<T, 8, true>() : kernel_ptr<T, 8, false>();
  }
}

struct Config {
  bool resident;
  int rows;    // batch rows per block
  int chunk;   // batch rows per launch
  int blocks;  // blocks of a full-chunk launch
  int smem;
};

// Resident W: the smallest R (most blocks, so the most SMs) whose grid is
// co-resident. W in L2: the largest R up to the batch (each batch tile
// streams the whole W slice from L2 every step, so fewer tiles move fewer
// bytes). Returns kErrNotCoResident when no grid for ``batch`` rows fits.
template <typename T>
int choose_grid(int batch, int hidden, int sms, int smem_optin,
                Config* out) {
  const int kpad = round_up(hidden, kKPad);
  const int unit_tiles = (hidden + kUnits - 1) / kUnits;
  const int small_first[] = {1, 2, 4, 8};
  const int large_first[] = {8, 4, 2, 1};
  for (int pass = 0; pass < 2; ++pass) {
    const bool resident = pass == 0;
    for (int i = 0; i < 4; ++i) {
      const int rows = resident ? small_first[i] : large_first[i];
      if (!resident && rows > 1 && rows / 2 >= batch) continue;
      const int blocks = unit_tiles * ((batch + rows - 1) / rows);
      const int smem =
          (resident ? w_smem_bytes(kpad, static_cast<int>(sizeof(T))) : 0) +
          static_cast<int>(sizeof(float)) *
              (rows * kpad + kWarps * 4 * rows * kUnits);
      if (smem > smem_optin) continue;
      void* kern = pick_kernel<T>(resident, rows);
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (blocks <= per_sm * sms) {
        *out = {resident, rows, batch, blocks, smem};
        return 0;
      }
    }
  }
  return kErrNotCoResident;
}

// The whole batch in one launch when its grid fits, else the fewest equal
// chunks whose grid does.
template <typename T>
int choose_config(int batch, int hidden, int sms, int smem_optin,
                  Config* out) {
  for (int launches = 1; launches <= batch; ++launches) {
    const int chunk = (batch + launches - 1) / launches;
    const int rc = choose_grid<T>(chunk, hidden, sms, smem_optin, out);
    if (rc != kErrNotCoResident) return rc;
  }
  return kErrNotCoResident;
}

std::mutex config_mutex;
std::map<std::tuple<int, int, int, int>, Config> config_cache;

template <typename T>
int launch_unit_tiles(int dtype, const void* gates, const void* mask,
                      const void* w_rec, const void* peep, const void* h0,
                      const void* c0, void* h_seq, void* c_seq, void* hbuf,
                      int steps, int batch, int hidden, int device,
                      cudaStream_t stream, int* info) {
  Config cfg{};
  {
    // the choice (and the kernel's shared-memory limit it sets) is made
    // once per shape; later launches reuse it
    std::lock_guard<std::mutex> lock(config_mutex);
    const auto key = std::make_tuple(dtype, batch, hidden, device);
    auto it = config_cache.find(key);
    if (it == config_cache.end()) {
      int sms = 0, smem_optin = 0;
      cudaError_t err =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaDeviceGetAttribute(
          &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int rc = choose_config<T>(batch, hidden, sms, smem_optin, &cfg);
      if (rc != 0) return rc;
      config_cache[key] = cfg;
    } else {
      cfg = it->second;
    }
    // a later shape may have lowered this kernel's limit: set it again
    cudaError_t err = cudaFuncSetAttribute(
        pick_kernel<T>(cfg.resident, cfg.rows),
        cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  info[0] = cfg.blocks;
  info[1] = cfg.rows;
  info[2] = cfg.resident ? 1 : 0;
  info[3] = cfg.smem;
  info[4] = cfg.chunk;
  info[5] = 0;  // launches made
  const T* w = static_cast<const T*>(w_rec);
  const float* p = static_cast<const float*>(peep);
  int unit_tiles = (hidden + kUnits - 1) / kUnits;
  int stride = batch;
  for (int b0 = 0; b0 < batch; b0 += cfg.chunk) {
    int rows = std::min(cfg.chunk, batch - b0);
    const size_t hb = static_cast<size_t>(b0) * hidden;
    const T* g = static_cast<const T*>(gates) + 4 * hb;
    const float* m = static_cast<const float*>(mask) + b0;
    const T* hh = static_cast<const T*>(h0) + hb;
    const T* cc = static_cast<const T*>(c0) + hb;
    T* hs_out = static_cast<T*>(h_seq) + hb;
    T* cs_out = static_cast<T*>(c_seq) + hb;
    T* buf = static_cast<T*>(hbuf) + hb;
    void* args[] = {&g,     &m,      &w,      &p,      &hh,
                    &cc,    &hs_out, &cs_out, &buf,    &steps,
                    &rows,  &stride, &hidden, &unit_tiles};
    const int blocks = unit_tiles * ((rows + cfg.rows - 1) / cfg.rows);
    cudaError_t err = cudaLaunchCooperativeKernel(
        pick_kernel<T>(cfg.resident, cfg.rows), dim3(blocks), dim3(kThreads),
        args, cfg.smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++info[5];
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}


// ---------------------------------------------------------------------------
// Clusters: one thread-block cluster per batch tile.

// The layout's shared memory has a copy in the caller's planner
// (ops/lstm_kernels.py, _fwd_cl_smem), which a CPU test holds equal to
// this: [W's column slice, where it is not in registers] [h_{t-1} of the
// block's rows, two parities, R x x_pitch floats each] [the product's
// scratch].
__host__ __device__ constexpr int cl_smem_bytes(int hidden, int rows,
                                                int elem_bytes) {
  return fwdcl::w_bytes((hidden + kUnits - 1) / kUnits, kCols, elem_bytes) +
         2 * rows * fwdcl::x_pitch((hidden + kUnits - 1) / kUnits) *
             static_cast<int>(sizeof(float)) +
         fwdcl::scratch_floats(kCols, rows, elem_bytes) *
             static_cast<int>(sizeof(float));
}

template <typename T, int R, bool kRegW>
__global__ void __launch_bounds__(fwdcl::kThreads, 1)
lstm_fwd_cluster(const T* __restrict__ gates, const float* __restrict__ mask,
                 const T* __restrict__ w_rec, const float* __restrict__ peep,
                 const T* __restrict__ h0, const T* __restrict__ c0,
                 T* __restrict__ h_seq, T* __restrict__ c_seq, int steps,
                 int batch, int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Prod = fwdcl::Product<T, R, kCols, kRegW>;
  cg::cluster_group cluster = cg::this_cluster();
  const int tiles = gridDim.x;  // the cluster: one block per unit tile
  const int xp = fwdcl::x_pitch(tiles);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kUnits;  // blockIdx.x: the rank in the cluster
  const int u = u0 + lane;
  const int b0 = blockIdx.y * R;
  const int b = b0 + warp;  // warp r owns row r of the tile
  const bool owner = warp < R && u < hidden && b < batch;
  const int g4 = 4 * hidden;

  // shared memory: [W slice] [hx: h of every unit, 2 parities x R rows]
  // [scratch]; rows past the batch and units past H stay zero
  float* hx = reinterpret_cast<float*>(
      smem_raw + fwdcl::w_bytes(tiles, kCols, static_cast<int>(sizeof(T))));
  float* scratch = hx + 2 * R * xp;
  Prod prod;
  prod.load(w_rec, hidden, u0, tiles, smem_raw);
  for (int e = threadIdx.x; e < 2 * R * xp; e += kThreads) {
    const int r = (e / xp) % R;
    const int k = e % xp;
    hx[e] = e < R * xp && b0 + r < batch && k < hidden
                ? to_f(h0[static_cast<size_t>(b0 + r) * hidden + k])
                : 0.f;
  }

  float pi = 0.f, pf = 0.f, po = 0.f, c = 0.f, h = 0.f;
  float zg[4] = {0.f, 0.f, 0.f, 0.f};
  float mk = 0.f;
  // the gates and mask of step t: plain loads, nothing waits for them
  // before the cell of step t (a comparison here would stall the barrier)
  auto fetch = [&](int t) {
    const size_t row = static_cast<size_t>(t) * batch + b;
    const T* gp = gates + row * g4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) zg[q] = load_ro(gp + q * hidden);
    mk = mask[row];
  };
  if (owner) {
    pi = peep[u];
    pf = peep[hidden + u];
    po = peep[2 * hidden + u];
    const size_t o = static_cast<size_t>(b) * hidden + u;
    h = to_f(h0[o]);
    c = to_f(c0[o]);
    fetch(0);
  }
  // every peer's buffers exist and are initialised (and this block's W
  // slice is complete) before anyone stores into a peer
  cluster.sync();

  for (int t = 0; t < steps; ++t) {
    prod.run(hx + (t & 1) * R * xp, xp, scratch);
    if (owner) {
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        z[q] = zg[q] + Prod::sum(scratch, warp, q * kUnits + lane);
      }
      const float ig = sigmoidf(z[0] + c * pi);
      const float fg = sigmoidf(z[1] + c * pf);
      const float gg = tanhf(z[2]);
      const float cn = fg * c + ig * gg;
      const float og = sigmoidf(z[3] + cn * po);
      const float hn = og * tanhf(cn);
      if (mk > 0.f) {
        c = cn;
        h = to_f(from_f<T>(hn));
      }
      const size_t o = (static_cast<size_t>(t) * batch + b) * hidden + u;
      h_seq[o] = from_f<T>(h);
      c_seq[o] = from_f<T>(c);
      // h_t into every block's buffer of the next parity
      float* nx = hx + ((t + 1) & 1) * R * xp + warp * xp + u;
      for (int p = 0; p < tiles; ++p) *cluster.map_shared_rank(nx, p) = h;
    }
    sm90::cluster_arrive();
    if (owner && t + 1 < steps) fetch(t + 1);
    sm90::cluster_wait();
  }
  // no peer addresses this block's shared memory after the last barrier
}

template <typename T, int R>
void* cl_kernel_w(int tiles) {
  return fwdcl::reg_w(tiles)
             ? reinterpret_cast<void*>(lstm_fwd_cluster<T, R, true>)
             : reinterpret_cast<void*>(lstm_fwd_cluster<T, R, false>);
}

// rows per block: 1, 2, 3, 4, 5 or 8; W in registers for clusters of at
// most 8 blocks
template <typename T>
void* cl_kernel(int rows, int tiles) {
  switch (rows) {
    case 1:
      return cl_kernel_w<T, 1>(tiles);
    case 2:
      return cl_kernel_w<T, 2>(tiles);
    case 3:
      return cl_kernel_w<T, 3>(tiles);
    case 4:
      return cl_kernel_w<T, 4>(tiles);
    case 5:
      return cl_kernel_w<T, 5>(tiles);
    default:
      return cl_kernel_w<T, 8>(tiles);
  }
}

// One launch of ceil(B / rows) clusters of ceil(H / 32) blocks. The rows
// per block come from the caller's planner; this checks that the layout
// takes the shape (a block that does not fit the card's shared memory is
// refused by the launch).
template <typename T>
int launch_cluster_layout(const void* gates, const void* mask,
                          const void* w_rec, const void* peep, const void* h0,
                          const void* c0, void* h_seq, void* c_seq, int steps,
                          int batch, int hidden, int rows,
                          cudaStream_t stream, int* info) {
  const int tiles = (hidden + kUnits - 1) / kUnits;
  if (hidden % 8 != 0 || tiles > fwdcl::kMaxTiles ||
      ((rows < 1 || rows > 5) && rows != 8)) {
    return kErrBadArgument;
  }
  const int batch_tiles = (batch + rows - 1) / rows;
  const int smem = cl_smem_bytes(hidden, rows, static_cast<int>(sizeof(T)));
  info[0] = tiles * batch_tiles;
  info[1] = rows;
  info[2] = 5;  // W's column slice on chip, h exchanged through DSMEM
  info[3] = smem;
  info[4] = batch;
  info[5] = 0;  // launches made
  const T* g = static_cast<const T*>(gates);
  const float* m = static_cast<const float*>(mask);
  const T* w = static_cast<const T*>(w_rec);
  const float* p = static_cast<const float*>(peep);
  const T* hh = static_cast<const T*>(h0);
  const T* cc = static_cast<const T*>(c0);
  T* hs_out = static_cast<T*>(h_seq);
  T* cs_out = static_cast<T*>(c_seq);
  void* args[] = {&g,      &m,      &w,     &p,     &hh,     &cc,
                  &hs_out, &cs_out, &steps, &batch, &hidden};
  const int rc = sm90::launch_clusters(cl_kernel<T>(rows, tiles), tiles,
                                       batch_tiles, kThreads, smem, stream,
                                       args);
  if (rc != 0) return rc;
  info[5] = 1;
  return 0;
}

// ---------------------------------------------------------------------------
// Grid: W spread over the shared memory of one persistent grid.

// The layout's constants and gr_smem_bytes have a copy in the caller's
// planner (ops/lstm_kernels.py, _GR_*), which a CPU test holds equal to
// these.
constexpr int kGrRows = 64;       // batch rows per pass
constexpr int kGrMaxPasses = 2;   // passes per step: 128 rows per launch
constexpr int kGrMaxUnits = 10;   // units per block (an even count; one
                                  // warp per unit: 204 registers a thread)
constexpr int kGrStages = 3;      // staged K chunks of h in flight
constexpr int kGrKcF32 = 32;      // K chunk, float32
constexpr int kGrKcBf16 = 64;     // K chunk, bfloat16
constexpr int kGrLdBf16 = kGrRows + 8;  // staged bf16 row: ldmatrix banks
constexpr int kGrKLanes = 8;      // float32: the lanes that split K

// float32 W row pitch: 4U floats, or 4U + 4 where U % 4 == 0 (the four K
// lanes of a load phase would share bank groups)
// float32 staging: the float4 j of staged row k sits at j ^ gr_swizzle(k),
// so that the 8 lanes of a load phase (4 k x 2 row groups) hit 8 bank
// groups
__host__ __device__ constexpr int gr_swizzle(int k) {
  return (k & 1) | ((k & 2) << 1);
}
__host__ __device__ constexpr int gr_wp(int units) {
  return 4 * units + (units % 4 == 0 ? 4 : 0);
}

// bfloat16: n8 tiles of the block's 4U columns
__host__ __device__ constexpr int gr_nt(int units) {
  return (4 * units + 7) / 8;
}

// Shared memory of a grid block in bytes. float32: W [K rounded up to 32]
// [gr_wp] and the staging ring [3][32][64] floats; bfloat16: W's B
// fragments [K rounded up to 64 / 16][gr_nt][32 lanes] x 8 bytes, the
// staging ring [3][64][72] and the tile [64][8 gr_nt] in float32.
__host__ __device__ constexpr int gr_smem_bytes(int hidden, int units,
                                                int elem_bytes) {
  return elem_bytes == 4
             ? round_up(hidden, kGrKcF32) * gr_wp(units) * 4 +
                   kGrStages * kGrKcF32 * kGrRows * 4
             : round_up(hidden, kGrKcBf16) / 16 * gr_nt(units) * 32 * 8 +
                   kGrStages * kGrKcBf16 * kGrLdBf16 * 2 +
                   kGrRows * gr_nt(units) * 8 * 4;
}

// In a pass a block forms the tile z [64 rows, 4U columns] (column c = 4 ul
// + q: unit ul, gate q). float32: the tile is cut into 8 x U/2 register
// tiles of 8 rows x 8 columns (two units), each held by 8 lanes that split
// K (lane bits 0, 1, 3; bits 2 and 4 pick one of the warp's four tiles), so
// that a k costs four 16-byte shared-memory loads for 64 FMAs. The 8 lanes'
// partial sums are then reduce-scattered by shuffles in fixed pairs (lane
// bit 3: rows 4 b3 .. of the tile kept, bit 1: rows 2 b1 .., bit 0: unit
// b0 of the two), leaving each lane the four gates of one unit at two
// rows: the cells the lane owns. bfloat16: the warps share the 2U (m16,
// n8) tiles, two each, and the tile goes through shared memory to the same
// owners.
template <typename T, int P>
__global__ void __launch_bounds__(32 * kGrMaxUnits, 1)
lstm_fwd_grid(const T* __restrict__ gates, const float* __restrict__ mask,
              const T* __restrict__ w_rec, const float* __restrict__ peep,
              const T* __restrict__ h0, const T* __restrict__ c0,
              T* __restrict__ h_seq, T* __restrict__ c_seq, T* hbuf,
              int steps, int batch, int stride, int hidden, int units) {
  // batch: the rows of this launch; stride: the rows of the whole batch
  // (the pointers start at this launch's first row); hbuf: [2][H][64 P]
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kKc = kMma ? kGrKcBf16 : kGrKcF32;
  constexpr int kLd = kMma ? kGrLdBf16 : kGrRows;  // staged row pitch
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // rows per copy
  constexpr int kPieces = kGrRows / kPer;  // 16-byte copies per staged row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int nthreads = 32 * units;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * units;
  // float32 register tile of this lane (see above) and its K lane
  const int tile = 4 * warp + (((lane >> 2) & 1) | ((lane >> 4) << 1));
  const int rg = tile % 8, cg_ = tile / 8;
  const int klane = (lane & 3) | (((lane >> 3) & 1) << 2);
  const int lb0 = lane & 1, lb1 = (lane >> 1) & 1, lb3 = (lane >> 3) & 1;
  // the cells of this lane: unit ul, rows rbase and rbase + 1 of a pass
  const int ul = 2 * cg_ + lb0;
  const int rbase = 8 * rg + 4 * lb3 + 2 * lb1;
  const int u = u0 + ul;
  const bool u_ok = ul < units && u < hidden;
  const int kpad = round_up(hidden, kKc);
  const int nchunks = kpad / kKc;
  const int bpad = kGrRows * P;
  const int g4 = 4 * hidden;
  const int wp = gr_wp(units);
  const int nts = gr_nt(units);
  const size_t hsz = static_cast<size_t>(hidden) * bpad;

  const int wbytes = kMma ? kpad / 16 * nts * 32 * 8 : kpad * wp * 4;
  T* stage = reinterpret_cast<T*>(smem_raw + wbytes);
  float* zs = reinterpret_cast<float*>(smem_raw + wbytes +
                                       kGrStages * kKc * kLd * sizeof(T));
  const int zp = 8 * nts;
  auto wval = [&](int k, int uu, int q) {  // W[k, q H + u0 + uu], zero-padded
    return k < hidden && uu < units && u0 + uu < hidden
               ? to_f(w_rec[static_cast<size_t>(k) * g4 + q * hidden + u0 +
                            uu])
               : 0.f;
  };
  if constexpr (kMma) {
    // B fragments: n-tile nt holds block columns 8 nt .. 8 nt + 7; lane
    // (gq, t) holds B[2t, 2t + 1][gq] and B[2t + 8, 2t + 9][gq] of each
    // k16 step
    uint2* wf = reinterpret_cast<uint2*>(smem_raw);
    for (int e = threadIdx.x; e < kpad / 16 * nts * 32; e += nthreads) {
      const int l = e % 32;
      const int nt = (e / 32) % nts;
      const int k = e / (32 * nts) * 16 + 2 * (l % 4);
      const int c = nt * 8 + l / 4;
      wf[e] = make_uint2(sm90::pack_bf16(make_float2(wval(k, c / 4, c % 4),
                                                     wval(k + 1, c / 4,
                                                          c % 4))),
                         sm90::pack_bf16(make_float2(wval(k + 8, c / 4,
                                                          c % 4),
                                                     wval(k + 9, c / 4,
                                                          c % 4))));
    }
  } else {
    float* ws = reinterpret_cast<float*>(smem_raw);
    // consecutive threads read consecutive units of one gate row; the pad
    // columns are zero
    for (int e = threadIdx.x; e < kpad * wp; e += nthreads) {
      const int k = e / wp, c = e % wp;
      ws[e] = c < 4 * units ? wval(k, c / 4, c % 4) : 0.f;
    }
  }

  float pi = 0.f, pf = 0.f, po = 0.f;
  float c[P][2], h[P][2], zg[P][2][4], mk[P][2];
  if (u_ok) {
    pi = peep[u];
    pf = peep[hidden + u];
    po = peep[2 * hidden + u];
  }
  // gates and mask of step t (plain loads: nothing waits for them before
  // the cells of step t)
  auto fetch = [&](int t) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = p * kGrRows + rbase + i;
        if (u_ok && b < batch) {
          const size_t row = static_cast<size_t>(t) * stride + b;
          const T* gp = gates + row * g4 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) zg[p][i][q] = load_ro(gp + q * hidden);
          mk[p][i] = mask[row];
        }
      }
  };
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = p * kGrRows + rbase + i;
      c[p][i] = h[p][i] = mk[p][i] = 0.f;
      zg[p][i][0] = zg[p][i][1] = zg[p][i][2] = zg[p][i][3] = 0.f;
      if (u_ok && b < batch) {
        const size_t o = static_cast<size_t>(b) * hidden + u;
        h[p][i] = to_f(h0[o]);
        c[p][i] = to_f(c0[o]);
        hbuf[static_cast<size_t>(u) * bpad + b] = h0[o];
      }
    }
  fetch(0);
  grid.sync();  // h0 in the buffer everywhere (and this block's W slice)

  for (int t = 0; t < steps; ++t) {
    const T* hsrc = hbuf + (t & 1) * hsz;
    T* hdst = hbuf + ((t + 1) & 1) * hsz;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      // stage K chunk ``ch`` of rows 64 p .. 64 p + 63 of h_{t-1} into ring
      // slot ``slot`` (zero past H and past the launch's rows)
      auto issue = [&](int ch, int slot) {
        T* dst = stage + slot * kKc * kLd;
        for (int e = threadIdx.x; e < kKc * kPieces; e += nthreads) {
          const int kk = e / kPieces, j = e % kPieces;
          const int k = ch * kKc + kk;
          const int r0 = p * kGrRows + j * kPer;
          const int valid = k < hidden ? max(0, min(kPer, batch - r0)) : 0;
          const T* src =
              hsrc + static_cast<size_t>(min(k, hidden - 1)) * bpad + r0;
          // float32: the float4 of a staged row XOR-swizzled by k % 4
          const int jp = kMma ? j : (j ^ gr_swizzle(kk));
          sm90::cp_async16(dst + kk * kLd + jp * kPer, src,
                           valid * static_cast<int>(sizeof(T)));
        }
      };
      // the K loop over the ring: chunk ch + 2 is issued once every thread
      // is past chunk ch - 1 (the barrier of chunk ch), so one block
      // barrier per chunk
      auto k_loop = [&](auto&& compute) {
        issue(0, 0);
        sm90::cp_async_commit();
        if (nchunks > 1) issue(1, 1);
        sm90::cp_async_commit();
        for (int ch = 0; ch < nchunks; ++ch) {
          sm90::cp_async_wait<1>();  // chunk ch has landed
          __syncthreads();
          if (ch + 2 < nchunks) issue(ch + 2, (ch + 2) % kGrStages);
          sm90::cp_async_commit();
          compute(ch, stage + (ch % kGrStages) * kKc * kLd);
        }
        sm90::cp_async_wait<0>();
        __syncthreads();  // every thread is done with the ring
      };
      float z[2][4];
      if constexpr (!kMma) {
        float acc[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
        const float* ws = reinterpret_cast<const float*>(smem_raw);
        const int sw = gr_swizzle(klane);
        k_loop([&](int ch, const T* st) {
          const float* wk = ws + static_cast<size_t>(ch * kKc) * wp + 8 * cg_;
#pragma unroll
          for (int i = 0; i < kKc / kGrKLanes; ++i) {
            const int kk = klane + kGrKLanes * i;
            const float* hr = st + kk * kLd;
            const float4 ha = sm90::load4(hr + 4 * ((2 * rg) ^ sw));
            const float4 hb = sm90::load4(hr + 4 * ((2 * rg + 1) ^ sw));
            const float4 wa = sm90::load4(wk + kk * wp);
            const float4 wb = sm90::load4(wk + kk * wp + 4);
            const float hv[8] = {ha.x, ha.y, ha.z, ha.w,
                                 hb.x, hb.y, hb.z, hb.w};
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[r][j] = fmaf(hv[r], wv[j], acc[r][j]);
          }
        });
        // the 8 K lanes' sums, reduce-scattered in fixed pairs
        constexpr unsigned kAll = 0xffffffffu;
        float v2[4][8], v3[2][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float send = lb3 ? acc[r][j] : acc[r + 4][j];
            const float keep = lb3 ? acc[r + 4][j] : acc[r][j];
            v2[r][j] = keep + __shfl_xor_sync(kAll, send, 8);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float send = lb1 ? v2[r][j] : v2[r + 2][j];
            const float keep = lb1 ? v2[r + 2][j] : v2[r][j];
            v3[r][j] = keep + __shfl_xor_sync(kAll, send, 2);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float send = lb0 ? v3[r][q] : v3[r][q + 4];
            const float keep = lb0 ? v3[r][q + 4] : v3[r][q];
            z[r][q] = keep + __shfl_xor_sync(kAll, send, 1);
          }
      } else {
        // work items: (m16 tile of rows, n8 tile of columns), 2U of them:
        // warp w takes items w and w + U
        const uint2* wf = reinterpret_cast<const uint2*>(smem_raw);
        // ldmatrix.x4.trans: lane i addresses row i % 8 of 8 x 8 tile i / 8
        // (tile bit 0: rows + 8 of A, bit 1: k + 8), stored k-major
        const int a_off = (((lane >> 3) >> 1) * 8 + (lane & 7)) * kLd +
                          ((lane >> 3) & 1) * 8;
        int mt[2], nt[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mt[j] = (warp + j * units) % 4;
          nt[j] = (warp + j * units) / 4;
        }
        float d[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
        }
        k_loop([&](int ch, const T* st) {
          // every fragment of the chunk first, then the products, so that
          // the loads' latencies overlap
          uint32_t a[kKc / 16][2][4];
          uint2 bv[kKc / 16][2];
#pragma unroll
          for (int k16 = 0; k16 < kKc / 16; ++k16)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              sm90::ldmatrix_x4_trans(
                  a[k16][j], st + k16 * 16 * kLd + mt[j] * 16 + a_off);
              bv[k16][j] =
                  wf[((ch * kKc / 16 + k16) * nts + nt[j]) * 32 + lane];
            }
#pragma unroll
          for (int k16 = 0; k16 < kKc / 16; ++k16)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              sm90::mma_bf16(d[j], a[k16][j], bv[k16][j].x, bv[k16][j].y);
        });
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = mt[j] * 16 + lane / 4;
          const int n = nt[j] * 8 + 2 * (lane % 4);
          zs[m * zp + n] = d[j][0];
          zs[m * zp + n + 1] = d[j][1];
          zs[(m + 8) * zp + n] = d[j][2];
          zs[(m + 8) * zp + n + 1] = d[j][3];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 v = sm90::load4(zs + (rbase + i) * zp + 4 * ul);
          z[i][0] = v.x;
          z[i][1] = v.y;
          z[i][2] = v.z;
          z[i][3] = v.w;
        }
      }
      // the cells of this pass
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = p * kGrRows + rbase + i;
        if (u_ok && b < batch) {
          const float cp = c[p][i];
          const float ig = sigmoidf(zg[p][i][0] + z[i][0] + cp * pi);
          const float fg = sigmoidf(zg[p][i][1] + z[i][1] + cp * pf);
          const float gg = tanhf(zg[p][i][2] + z[i][2]);
          const float cn = fg * cp + ig * gg;
          const float og = sigmoidf(zg[p][i][3] + z[i][3] + cn * po);
          const float hn = og * tanhf(cn);
          if (mk[p][i] > 0.f) {
            c[p][i] = cn;
            h[p][i] = to_f(from_f<T>(hn));
          }
          const T hv = from_f<T>(h[p][i]);
          const size_t o = (static_cast<size_t>(t) * stride + b) * hidden + u;
          h_seq[o] = hv;
          c_seq[o] = from_f<T>(c[p][i]);
          hdst[static_cast<size_t>(u) * bpad + b] = hv;
        }
      }
    }
    grid.sync();  // h_t complete everywhere before any block stages it
    if (t + 1 < steps) fetch(t + 1);  // used at the end of the next step
  }
}

template <typename T>
void* gr_kernel(int passes) {
  return passes == 1 ? reinterpret_cast<void*>(lstm_fwd_grid<T, 1>)
                     : reinterpret_cast<void*>(lstm_fwd_grid<T, 2>);
}

// ``units`` units per block (ceil(H / units) blocks, one per SM) and at
// most ``rows`` rows per launch, both from the caller's planner: equal row
// chunks of at most 128 rows, one cooperative launch each. The grid must
// be co-resident: kErrNotCoResident where the card cannot hold it, a
// launch error where the block does not fit its shared memory.
template <typename T>
int launch_grid_layout(const void* gates, const void* mask,
                       const void* w_rec, const void* peep, const void* h0,
                       const void* c0, void* h_seq, void* c_seq, void* hbuf,
                       int steps, int batch, int hidden, int units, int rows,
                       int device, cudaStream_t stream, int* info) {
  if (units < 2 || units > kGrMaxUnits || units % 2 != 0 || rows < 1 ||
      rows > kGrRows * kGrMaxPasses) {
    return kErrBadArgument;
  }
  const int passes = (rows + kGrRows - 1) / kGrRows;
  const int blocks = (hidden + units - 1) / units;
  const int threads = 32 * units;
  const int smem = gr_smem_bytes(hidden, units, static_cast<int>(sizeof(T)));
  void* kern = gr_kernel<T>(passes);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > per_sm * sms) return kErrNotCoResident;
  info[0] = blocks;
  info[1] = rows;  // every block serves every row of the launch
  info[2] = 4;     // W spread over the grid's shared memory
  info[3] = smem;
  info[4] = rows;
  info[5] = 0;  // launches made
  const T* w = static_cast<const T*>(w_rec);
  const float* p = static_cast<const float*>(peep);
  T* buf = static_cast<T*>(hbuf);
  int stride = batch;
  for (int b0 = 0; b0 < batch; b0 += rows) {
    int n = std::min(rows, batch - b0);
    const size_t hb = static_cast<size_t>(b0) * hidden;
    const T* g = static_cast<const T*>(gates) + 4 * hb;
    const float* m = static_cast<const float*>(mask) + b0;
    const T* hh = static_cast<const T*>(h0) + hb;
    const T* cc = static_cast<const T*>(c0) + hb;
    T* hs_out = static_cast<T*>(h_seq) + hb;
    T* cs_out = static_cast<T*>(c_seq) + hb;
    void* args[] = {&g,      &m,   &w,     &p, &hh,     &cc,     &hs_out,
                    &cs_out, &buf, &steps, &n, &stride, &hidden, &units};
    err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(threads), args,
                                      smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++info[5];
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (gates, w_rec, h0, c0, h_seq, c_seq,
// hbuf); mask and peep are float32.
// layout 0 = unit tiles: hbuf is scratch of 2*B*H elements; units and rows
//   are not read (the grid and W placement are chosen here).
// layout 1 = grid of ``units`` (even, <= 10) units per block, at most
//   ``rows`` rows per launch (<= 128): hbuf is scratch of
//   2 * H * 64 * ceil(rows / 64) elements.
// layout 2 = clusters (H % 8 == 0, H <= 512) of ``rows`` (1, 2, 3, 4, 5,
//   8) batch rows per block; hbuf and units are not read.
// info receives {blocks of a full-chunk launch, batch rows per block,
// W placement (unit tiles: 1 resident, 0 in L2; grid: 4; clusters: 5),
// dynamic shared memory bytes, batch rows per launch, launches made}: unit
// tiles and the grid run a batch larger than one launch takes as several
// launches of equal chunks.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int lstm_seq_fwd(int dtype, const void* gates, const void* mask,
                 const void* w_rec, const void* peep, const void* h0,
                 const void* c0, void* h_seq, void* c_seq, void* hbuf,
                 int steps, int batch, int hidden, int layout, int units,
                 int rows, int device, void* stream, int* info) {
  if (steps < 1 || batch < 1 || hidden < 1 || (dtype != 0 && dtype != 1) ||
      layout < 0 || layout > 2) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 2) {
    if (dtype == 0) {
      return launch_cluster_layout<float>(gates, mask, w_rec, peep, h0, c0,
                                          h_seq, c_seq, steps, batch, hidden,
                                          rows, s, info);
    }
    return launch_cluster_layout<__nv_bfloat16>(gates, mask, w_rec, peep, h0,
                                                c0, h_seq, c_seq, steps, batch,
                                                hidden, rows, s, info);
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  if (layout == 1) {
    if (dtype == 0) {
      return launch_grid_layout<float>(gates, mask, w_rec, peep, h0, c0,
                                       h_seq, c_seq, hbuf, steps, batch,
                                       hidden, units, rows, device, s, info);
    }
    return launch_grid_layout<__nv_bfloat16>(
        gates, mask, w_rec, peep, h0, c0, h_seq, c_seq, hbuf, steps, batch,
        hidden, units, rows, device, s, info);
  }
  if (dtype == 0) {
    return launch_unit_tiles<float>(dtype, gates, mask, w_rec, peep, h0, c0,
                                    h_seq, c_seq, hbuf, steps, batch, hidden,
                                    device, s, info);
  }
  return launch_unit_tiles<__nv_bfloat16>(dtype, gates, mask, w_rec, peep, h0,
                                          c0, h_seq, c_seq, hbuf, steps,
                                          batch, hidden, device, s, info);
}

// The card's limits that ops/lstm_kernels.fwd_plan sizes its layouts by
// (sm90::card_limits: SM count, opt-in shared memory per block, clusters
// of 8 and of 16 of this file's cluster kernel held at once). Returns 0 or
// a cudaError_t value.
int lstm_seq_fwd_limits(int device, int* out) {
  return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, device, out);
}

const char* lstm_seq_fwd_error_string(int code) {
  switch (code) {
    case kErrNotCoResident:
      return "no co-resident grid: the batch and hidden size need more "
             "blocks than a cooperative launch can hold";
    case kErrNoCooperative:
      return "device does not support cooperative launches";
    case kErrBadArgument:
      return "bad argument (dtype or layout code, an empty shape, or a "
             "cluster or grid the layout does not take)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
