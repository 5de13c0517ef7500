// Whole-sequence masked GRU forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
//   _gru_fwd_kernel  (:668, called by _gru_fwd :695, "K5")
//
// Function (gate column order u, r, c; proj_tm already holds x.W_in + b):
//   [z_u, z_r] = proj_{u,r} + h_{t-1} . W_rz          (f32 accumulation)
//   u, r       = sigmoid(z_u), sigmoid(z_r)
//   rh         = round(r * h_{t-1})                    (to the input dtype)
//   c          = tanh(proj_c + rh . W_c)               (f32 accumulation)
//   h_t        = u * h_{t-1} + (1 - u) * c             (stored in the input dtype)
// The UPDATE gate u keeps the old state. A masked step (mask[t, b] == 0)
// copies h forward. The output is h_seq [T, B, H]; the final state is its
// last row.
//
// A GRU step needs TWO exchanges between the blocks that share a row where
// the LSTM needs one: the candidate's product (r . h_{t-1}) . W_c sums over
// all H units, so every unit's reset gate must be visible before any block
// can form its candidate. The T steps are serially dependent, and at the
// tagger's shapes (B <= 64, H = 256 or 512) one step's two products ([B, H]
// x [H, 2H], then [B, H] x [H, H]) are far too small to fill the card, so
// time is set by per-step latency. Two layouts, picked by the caller's
// planner (ops/gru_kernels.gru_fwd_plan) and recorded in info[2]; every sum
// runs in a fixed order, so a repeat is the same bit for bit.
//
// CLUSTERS (H % 8 == 0, at most 16 unit tiles: the tagger's H=256 in
// clusters of 8, the NMT encoder's H=512 in clusters of 16). Batch rows
// never exchange anything, so each batch tile of R rows is ONE thread-block
// cluster of ceil(H / 32) blocks, block j owning units 32j .. 32j + 31, and
// clusters never wait for each other (no cooperative launch). A block keeps
// its columns of W_rz (64) and W_c (32) on chip for the whole launch
// (fwd_cluster.cuh: in registers up to 8 blocks, else in shared memory:
// 96 KB at H=256 and 192 KB at H=512 in float32) and, in its own shared
// memory, h_{t-1} and round(r * h_{t-1}) of all units for its R rows. Per
// step (warp r: row r, lane l: unit l):
//   1. the u and r products of its units over the full K (float32 on the
//      CUDA cores; bfloat16 on the tensor cores, mma.sync), u and r, and
//      round(r * h_{t-1}) stored into every peer's rh rows (distributed
//      shared memory); cluster barrier 1;
//   2. the candidate's product against W_c, the cell update, h_t to h_seq
//      and into every peer's h rows; cluster barrier 2 (arrive; the next
//      step's projection and mask are fetched; wait).
// Two barriers a step also order the buffers, so neither needs a second
// copy: a block stores rh at step t after barrier 2 of step t - 1, which
// every peer reaches after its last read of rh (step t - 1's candidate),
// and h_t after barrier 1 of step t, which every peer reaches after its
// last read of h_{t-1} (step t's first product). R (1, 2, 3, 4, 5 or 8) is
// the smallest that keeps the batch's clusters co-resident
// (gru_seq_fwd_limits).
//
// UNIT TILES (what clusters do not take). ONE cooperative launch per
// sequence over a persistent grid. Block (unit tile, batch tile) owns 32
// hidden units (one per lane) x R batch rows for the whole sequence; warp
// r keeps the h of row r's 32 units in registers across all T steps. Per
// step a block
//   1. stages the h_{t-1} rows of its batch tile into shared memory
//      (h_seq[t-1] as other blocks wrote it, or h0, read with L2-only
//      loads),
//   2. splits K = H over its 8 warps: each warp sums, in f32 on CUDA cores,
//      the u and r columns of its 32 units for all R rows over its K slice
//      (W_rz's slice [H, 64] from shared memory when it fits, else from
//      L2); the partials are reduced in a fixed order, and each owner
//      writes round(r * h_{t-1}) of its unit to the scratch rows rh [B, H],
//   3. waits on the first grid barrier (rh of every unit is complete),
//   4. stages the rh rows of its batch tile and sums the c column of its
//      units against W_c's slice [H, 32] the same way, applies the cell
//      update, writes h_t to h_seq, prefetches proj_{t+1}, and waits on
//      the second grid barrier (h_t complete everywhere).
// The two barriers also order the scratch: rh is rewritten only after the
// second barrier, once every block has read it, and h_t is written only
// after the first, once every block has staged h_{t-1}; so neither needs a
// double buffer. The host picks R and the W placement so that the grid is
// co-resident (a cooperative launch refuses otherwise): resident W with
// the most blocks that fit, else W in L2 with the largest R. Rows are
// independent, so a batch too large for one co-resident grid is split into
// the fewest equal chunks that fit, one launch per chunk in stream order.

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
constexpr int kRzCols = 2 * kUnits;  // W_rz columns per block (u, r)
constexpr int kWarps = 8;          // K is split over the warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKPad = 4;  // K is padded to a multiple of this (float4 reads)
// staging pitch floor: the partial sums of the u and r columns alias the
// staging rows and need kWarps * 2 * 32 floats per row
constexpr int kStageMin = kWarps * 2 * kUnits;

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

// read-only inputs (W, proj): through the non-coherent cache
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// h_seq and the rh scratch are written by other blocks during the launch:
// read them from L2 (cache-global), never from a possibly stale L1 line
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

__host__ __device__ constexpr int stage_pitch(int kpad) {
  return kpad > kStageMin ? kpad : kStageMin;
}

// resident W: the W_rz slice [kpad, 64] then the W_c slice [kpad, 32]
__host__ __device__ constexpr int w_smem_bytes(int kpad, int elem_bytes) {
  return round_up(kpad * (kRzCols + kUnits) * elem_bytes, 16);
}

// Stage rows [b0, b0 + R) of ``src`` (row pitch ``hidden``) into
// st[r * sp + k] as f32, zero past H and past the launch's rows.
template <typename T, int R>
__device__ __forceinline__ void stage_rows(float* st, const T* src, int b0,
                                           int batch, int hidden, int kpad,
                                           int sp) {
  for (int e = threadIdx.x; e < R * kpad; e += kThreads) {
    const int r = e / kpad;
    const int k = e % kpad;
    const int bb = b0 + r;
    st[r * sp + k] = (bb < batch && k < hidden)
                         ? load_cg(src + static_cast<size_t>(bb) * hidden + k)
                         : 0.f;
  }
}

// W in L2: ask for 3 blocks per SM, so that wide grids stay co-resident
template <typename T, int R, bool kResident>
__global__ void __launch_bounds__(kThreads, kResident ? 1 : 3)
gru_seq_fwd_kernel(const T* __restrict__ proj, const float* __restrict__ mask,
                   const T* __restrict__ w_rz, const T* __restrict__ w_c,
                   const T* h0, T* h_seq, T* rh, int steps, int batch,
                   int stride, int hidden, int unit_tiles) {
  // batch: the rows of this launch; stride: the rows of the whole batch,
  // the pitch of every [T, B, ...] array (the pointers start at this
  // launch's first row; h0 and rh are [B, H] from that row)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int kpad = round_up(hidden, kKPad);
  const int sp = stage_pitch(kpad);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = (blockIdx.x % unit_tiles) * kUnits;
  const int u = u0 + lane;
  const int b0 = (blockIdx.x / unit_tiles) * R;
  const bool u_ok = u < hidden;
  const int g3 = 3 * hidden;
  const int h2 = 2 * hidden;
  const size_t bh = static_cast<size_t>(stride) * hidden;
  // this warp's K slice
  const int ks = round_up((kpad + kWarps - 1) / kWarps, kKPad);
  const int k_begin = min(kpad, warp * ks);
  const int k_end = min(kpad, k_begin + ks);
  // this warp's own row (warp r owns row r of the tile)
  const int b = b0 + warp;
  const bool owner = warp < R && u_ok && b < batch;

  // shared memory: [W_rz slice, W_c slice (resident only)]
  //                [staging R x sp floats: h or rh rows, then the partials]
  T* wrz_s = reinterpret_cast<T*>(smem_raw);
  T* wc_s = wrz_s + kpad * kRzCols;
  float* st = reinterpret_cast<float*>(
      smem_raw +
      (kResident ? w_smem_bytes(kpad, static_cast<int>(sizeof(T))) : 0));
  if (kResident) {
    // wrz_s[k][q * 32 + l] = W_rz[k, q * H + u0 + l]
    for (int e = threadIdx.x; e < kpad * kRzCols; e += kThreads) {
      const int k = e / kRzCols;
      const int j = e % kRzCols;
      const int uu = u0 + j % kUnits;
      wrz_s[e] = (k < hidden && uu < hidden)
                     ? w_rz[static_cast<size_t>(k) * h2 +
                            (j / kUnits) * hidden + uu]
                     : from_f<T>(0.f);
    }
    // wc_s[k][l] = W_c[k, u0 + l]
    for (int e = threadIdx.x; e < kpad * kUnits; e += kThreads) {
      const int k = e / kUnits;
      const int uu = u0 + e % kUnits;
      wc_s[e] = (k < hidden && uu < hidden)
                    ? w_c[static_cast<size_t>(k) * hidden + uu]
                    : from_f<T>(0.f);
    }
  }

  float h = 0.f;
  float xp[3] = {0.f, 0.f, 0.f};
  if (owner) {
    h = to_f(h0[static_cast<size_t>(b) * hidden + u]);
    const T* p = proj + static_cast<size_t>(b) * g3 + u;
#pragma unroll
    for (int q = 0; q < 3; ++q) xp[q] = load_ro(p + q * hidden);
  }
  __syncthreads();  // resident W complete

  for (int t = 0; t < steps; ++t) {
    // 1. stage h_{t-1} rows of this batch tile
    stage_rows<T, R>(st, t == 0 ? h0 : h_seq + (t - 1) * bh, b0, batch,
                     hidden, kpad, sp);
    __syncthreads();
    // 2. this warp's partial u and r sums over its K slice
    float acc[2][R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.f;
    if (u_ok) {
      for (int k = k_begin; k < k_end; k += 4) {
        float w[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (kResident) {
              w[kk][q] = to_f(wrz_s[(k + kk) * kRzCols + q * kUnits + lane]);
            } else {
              w[kk][q] = k + kk < hidden
                             ? load_ro(w_rz + static_cast<size_t>(k + kk) * h2 +
                                       q * hidden + u)
                             : 0.f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(st + r * sp + k);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[q][r] = fmaf(hv.x, w[0][q], acc[q][r]);
            acc[q][r] = fmaf(hv.y, w[1][q], acc[q][r]);
            acc[q][r] = fmaf(hv.z, w[2][q], acc[q][r]);
            acc[q][r] = fmaf(hv.w, w[3][q], acc[q][r]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the staged rows
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st[((warp * 2 + q) * R + r) * kUnits + lane] = acc[q][r];
      }
    }
    __syncthreads();
    // 3. owners reduce the partials (fixed order): u, r, and rh out
    float ug = 0.f;
    if (owner) {
      float s[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        s[q] = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s[q] += st[((w * 2 + q) * R + warp) * kUnits + lane];
        }
      }
      ug = sigmoidf(xp[0] + s[0]);
      const float rg = sigmoidf(xp[1] + s[1]);
      rh[static_cast<size_t>(b) * hidden + u] = from_f<T>(rg * h);
    }
    grid.sync();  // rh of every unit complete before any block reads it
    // 4. stage the rh rows; this warp's partial c sums over its K slice
    stage_rows<T, R>(st, rh, b0, batch, hidden, kpad, sp);
    __syncthreads();
    float cacc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cacc[r] = 0.f;
    if (u_ok) {
      for (int k = k_begin; k < k_end; k += 4) {
        float w[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kResident) {
            w[kk] = to_f(wc_s[(k + kk) * kUnits + lane]);
          } else {
            w[kk] = k + kk < hidden
                        ? load_ro(w_c + static_cast<size_t>(k + kk) * hidden +
                                  u)
                        : 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(st + r * sp + k);
          cacc[r] = fmaf(hv.x, w[0], cacc[r]);
          cacc[r] = fmaf(hv.y, w[1], cacc[r]);
          cacc[r] = fmaf(hv.z, w[2], cacc[r]);
          cacc[r] = fmaf(hv.w, w[3], cacc[r]);
        }
      }
    }
    __syncthreads();  // every warp is done with the staged rows
#pragma unroll
    for (int r = 0; r < R; ++r) st[(warp * R + r) * kUnits + lane] = cacc[r];
    __syncthreads();
    // owners: candidate, cell update, h_t out, next step's proj
    if (owner) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += st[(w * R + warp) * kUnits + lane];
      const float cg_ = tanhf(xp[2] + s);
      const float hn = ug * h + (1.f - ug) * cg_;
      const size_t row = static_cast<size_t>(t) * stride + b;
      if (mask[row] > 0.f) h = to_f(from_f<T>(hn));
      h_seq[row * hidden + u] = from_f<T>(h);
      if (t + 1 < steps) {  // next step's projection, off the critical path
        const T* p = proj + (row + stride) * g3 + u;
#pragma unroll
        for (int q = 0; q < 3; ++q) xp[q] = load_ro(p + q * hidden);
      }
    }
    grid.sync();  // h_t complete everywhere before any block stages it
  }
}

template <typename T, int R, bool kResident>
void* kernel_ptr() {
  return reinterpret_cast<void*>(gru_seq_fwd_kernel<T, R, kResident>);
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
// streams its W slices from L2 every step, so fewer tiles move fewer
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
          static_cast<int>(sizeof(float)) * rows * stage_pitch(kpad);
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
int launch_unit_tiles(int dtype, const void* proj, const void* mask,
                      const void* w_rz, const void* w_c, const void* h0,
                      void* h_seq, void* rh, int steps, int batch, int hidden,
                      int device, cudaStream_t stream, int* info) {
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
  const T* wrz = static_cast<const T*>(w_rz);
  const T* wc = static_cast<const T*>(w_c);
  int unit_tiles = (hidden + kUnits - 1) / kUnits;
  int stride = batch;
  for (int b0 = 0; b0 < batch; b0 += cfg.chunk) {
    int rows = std::min(cfg.chunk, batch - b0);
    const size_t hb = static_cast<size_t>(b0) * hidden;
    const T* p = static_cast<const T*>(proj) + 3 * hb;
    const float* m = static_cast<const float*>(mask) + b0;
    const T* hh = static_cast<const T*>(h0) + hb;
    T* hs_out = static_cast<T*>(h_seq) + hb;
    T* rr = static_cast<T*>(rh) + hb;
    void* args[] = {&p,     &m,    &wrz,    &wc,     &hh,        &hs_out,
                    &rr,    &steps, &rows,  &stride, &hidden, &unit_tiles};
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
// (ops/gru_kernels.py, _fwd_cl_smem), which a CPU test holds equal to
// this: [W_rz's and W_c's column slices, where they are not in registers]
// [h_{t-1} and rh of the block's rows, R x x_pitch floats each] [the
// products' scratch].
__host__ __device__ constexpr int cl_smem_bytes(int hidden, int rows,
                                                int elem_bytes) {
  return fwdcl::w_bytes((hidden + kUnits - 1) / kUnits, kRzCols,
                        elem_bytes) +
         fwdcl::w_bytes((hidden + kUnits - 1) / kUnits, kUnits, elem_bytes) +
         2 * rows * fwdcl::x_pitch((hidden + kUnits - 1) / kUnits) *
             static_cast<int>(sizeof(float)) +
         (fwdcl::scratch_floats(kRzCols, rows, elem_bytes) >
                  fwdcl::scratch_floats(kUnits, rows, elem_bytes)
              ? fwdcl::scratch_floats(kRzCols, rows, elem_bytes)
              : fwdcl::scratch_floats(kUnits, rows, elem_bytes)) *
             static_cast<int>(sizeof(float));
}

template <typename T, int R, bool kRegW>
__global__ void __launch_bounds__(fwdcl::kThreads, 1)
gru_fwd_cluster(const T* __restrict__ proj, const float* __restrict__ mask,
                const T* __restrict__ w_rz, const T* __restrict__ w_c,
                const T* __restrict__ h0, T* __restrict__ h_seq, int steps,
                int batch, int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using ProdRz = fwdcl::Product<T, R, kRzCols, kRegW>;
  using ProdC = fwdcl::Product<T, R, kUnits, kRegW>;
  constexpr int kEsz = static_cast<int>(sizeof(T));
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
  const int g3 = 3 * hidden;

  // shared memory: [W_rz slice] [W_c slice] [hx: h_{t-1}, R rows]
  // [rx: rh, R rows] [scratch]; rows past the batch and units past H stay
  // zero
  unsigned char* wc_s = smem_raw + fwdcl::w_bytes(tiles, kRzCols, kEsz);
  float* hx = reinterpret_cast<float*>(
      wc_s + fwdcl::w_bytes(tiles, kUnits, kEsz));
  float* rx = hx + R * xp;
  float* scratch = rx + R * xp;
  ProdRz prz;
  prz.load(w_rz, hidden, u0, tiles, smem_raw);
  ProdC pc;
  pc.load(w_c, hidden, u0, tiles, wc_s);
  for (int e = threadIdx.x; e < 2 * R * xp; e += kThreads) {
    const int r = (e / xp) % R;
    const int k = e % xp;
    hx[e] = e < R * xp && b0 + r < batch && k < hidden
                ? to_f(h0[static_cast<size_t>(b0 + r) * hidden + k])
                : 0.f;
  }

  float h = 0.f;
  float xpj[3] = {0.f, 0.f, 0.f};
  float mk = 0.f;
  // the projection and mask of step t: plain loads, nothing waits for them
  // before step t (a comparison here would stall the barrier)
  auto fetch = [&](int t) {
    const size_t row = static_cast<size_t>(t) * batch + b;
    const T* pp = proj + row * g3 + u;
#pragma unroll
    for (int q = 0; q < 3; ++q) xpj[q] = load_ro(pp + q * hidden);
    mk = mask[row];
  };
  if (owner) {
    h = to_f(h0[static_cast<size_t>(b) * hidden + u]);
    fetch(0);
  }
  // every peer's buffers exist and are initialised (and this block's W
  // slices are complete) before anyone stores into a peer
  cluster.sync();

  for (int t = 0; t < steps; ++t) {
    // 1. u and r; round(r * h_{t-1}) into every block's rh rows
    prz.run(hx, xp, scratch);
    float ug = 0.f;
    if (owner) {
      ug = sigmoidf(xpj[0] + ProdRz::sum(scratch, warp, lane));
      const float rg = sigmoidf(xpj[1] + ProdRz::sum(scratch, warp,
                                                     kUnits + lane));
      const float rh = to_f(from_f<T>(rg * h));
      float* dst = rx + warp * xp + u;
      for (int p = 0; p < tiles; ++p) *cluster.map_shared_rank(dst, p) = rh;
    }
    sm90::cluster_sync();  // rh of every unit, in every block
    // 2. the candidate, the cell update; h_t into every block's h rows
    pc.run(rx, xp, scratch);
    if (owner) {
      const float cg_ = tanhf(xpj[2] + ProdC::sum(scratch, warp, lane));
      const float hn = ug * h + (1.f - ug) * cg_;
      if (mk > 0.f) h = to_f(from_f<T>(hn));
      h_seq[(static_cast<size_t>(t) * batch + b) * hidden + u] = from_f<T>(h);
      float* dst = hx + warp * xp + u;
      for (int p = 0; p < tiles; ++p) *cluster.map_shared_rank(dst, p) = h;
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
             ? reinterpret_cast<void*>(gru_fwd_cluster<T, R, true>)
             : reinterpret_cast<void*>(gru_fwd_cluster<T, R, false>);
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
int launch_cluster_layout(const void* proj, const void* mask,
                          const void* w_rz, const void* w_c, const void* h0,
                          void* h_seq, int steps, int batch, int hidden,
                          int rows, cudaStream_t stream, int* info) {
  const int tiles = (hidden + kUnits - 1) / kUnits;
  if (hidden % 8 != 0 || tiles > fwdcl::kMaxTiles ||
      ((rows < 1 || rows > 5) && rows != 8)) {
    return kErrBadArgument;
  }
  const int batch_tiles = (batch + rows - 1) / rows;
  const int smem = cl_smem_bytes(hidden, rows, static_cast<int>(sizeof(T)));
  info[0] = tiles * batch_tiles;
  info[1] = rows;
  info[2] = 5;  // W's column slices on chip, h and rh exchanged via DSMEM
  info[3] = smem;
  info[4] = batch;
  info[5] = 0;  // launches made
  const T* p = static_cast<const T*>(proj);
  const float* m = static_cast<const float*>(mask);
  const T* wrz = static_cast<const T*>(w_rz);
  const T* wc = static_cast<const T*>(w_c);
  const T* hh = static_cast<const T*>(h0);
  T* hs_out = static_cast<T*>(h_seq);
  void* args[] = {&p,      &m,     &wrz,   &wc,    &hh,
                  &hs_out, &steps, &batch, &hidden};
  const int rc = sm90::launch_clusters(cl_kernel<T>(rows, tiles), tiles,
                                       batch_tiles, kThreads, smem, stream,
                                       args);
  if (rc != 0) return rc;
  info[5] = 1;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (proj, w_rz, w_c, h0, h_seq, rh); mask
// is float32.
// layout 0 = unit tiles: rh is scratch of B*H elements; rows is not read
//   (the grid and W placement are chosen here).
// layout 2 = clusters (H % 8 == 0, H <= 512) of ``rows`` (1, 2, 3, 4, 5,
//   8) batch rows per block; rh is not read.
// info receives {blocks of a full-chunk launch, batch rows per block, W
// placement (unit tiles: 1 resident, 0 in L2; clusters: 5), dynamic shared
// memory bytes, batch rows per launch, launches made}: unit tiles run a
// batch larger than one co-resident grid as several launches of equal
// chunks.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int gru_seq_fwd(int dtype, const void* proj, const void* mask,
                const void* w_rz, const void* w_c, const void* h0,
                void* h_seq, void* rh, int steps, int batch, int hidden,
                int layout, int rows, int device, void* stream, int* info) {
  if (steps < 1 || batch < 1 || hidden < 1 || (dtype != 0 && dtype != 1) ||
      (layout != 0 && layout != 2)) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 2) {
    if (dtype == 0) {
      return launch_cluster_layout<float>(proj, mask, w_rz, w_c, h0, h_seq,
                                          steps, batch, hidden, rows, s,
                                          info);
    }
    return launch_cluster_layout<__nv_bfloat16>(proj, mask, w_rz, w_c, h0,
                                                h_seq, steps, batch, hidden,
                                                rows, s, info);
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  if (dtype == 0) {
    return launch_unit_tiles<float>(dtype, proj, mask, w_rz, w_c, h0, h_seq,
                                    rh, steps, batch, hidden, device, s,
                                    info);
  }
  return launch_unit_tiles<__nv_bfloat16>(dtype, proj, mask, w_rz, w_c, h0,
                                          h_seq, rh, steps, batch, hidden,
                                          device, s, info);
}

// The card's limits that ops/gru_kernels.gru_fwd_plan sizes its layouts by
// (sm90::card_limits: SM count, opt-in shared memory per block, clusters
// of 8 and of 16 of this file's cluster kernel held at once). Returns 0 or
// a cudaError_t value.
int gru_seq_fwd_limits(int device, int* out) {
  return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, device, out);
}

const char* gru_seq_fwd_error_string(int code) {
  switch (code) {
    case kErrNotCoResident:
      return "no co-resident grid: the batch and hidden size need more "
             "blocks than a cooperative launch can hold";
    case kErrNoCooperative:
      return "device does not support cooperative launches";
    case kErrBadArgument:
      return "bad argument (dtype or layout code, an empty shape, or a "
             "cluster the layout does not take)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
