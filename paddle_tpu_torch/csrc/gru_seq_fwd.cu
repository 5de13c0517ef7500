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
// Design: ONE cooperative launch per sequence over a persistent grid, the
// skeleton of lstm_seq_fwd.cu. Block (unit tile, batch tile) owns 32
// hidden units (one per lane) x R batch rows for the whole sequence; warp
// r keeps the h of row r's 32 units in registers across all T steps. A GRU
// step needs TWO exchanges between blocks where the LSTM needs one: the
// candidate's product (r . h_{t-1}) . W_c sums over all H units, so every
// unit's reset gate must be visible before any block can form its
// candidate. Per step a block
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
//
// What bounds it on this card: the T steps are serially dependent, and at
// the tagger's shapes (B <= 64, H = 256 or 512) one step's two GEMVs
// ([B, H] x [H, 2H], then [B, H] x [H, H]) are far too small to fill the
// card, so time is set by per-step latency: two staging round trips
// through L2, two K loops and two grid barriers per step, about twice the
// LSTM forward's barrier count. Resident W slices (H x 96 values per
// block: 96 KB at H=256 and 192 KB at H=512 in f32) take the L2 round
// trips out of the K loops, and the split over 8 warps cuts each loop by
// 8. Fusing the two barriers (the candidate of unit j needs only r of all
// units, which a cluster could exchange through distributed shared
// memory) and tensor cores for bf16 come next.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

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
int launch(int dtype, const void* proj, const void* mask, const void* w_rz,
           const void* w_c, const void* h0, void* h_seq, void* rh, int steps,
           int batch, int hidden, int device, cudaStream_t stream,
           int* info) {
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (proj, w_rz, w_c, h0, h_seq, rh); mask
// is float32. rh is scratch of B*H elements. info receives {blocks of a
// full-chunk launch, batch rows per block, W resident, dynamic shared
// memory bytes, batch rows per launch, launches made}: a batch larger than
// one co-resident grid runs as several launches of equal chunks.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int gru_seq_fwd(int dtype, const void* proj, const void* mask,
                const void* w_rz, const void* w_c, const void* h0,
                void* h_seq, void* rh, int steps, int batch, int hidden,
                int device, void* stream, int* info) {
  if (steps < 1 || batch < 1 || hidden < 1) return kErrBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(dtype, proj, mask, w_rz, w_c, h0, h_seq, rh, steps,
                         batch, hidden, device, s, info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(dtype, proj, mask, w_rz, w_c, h0, h_seq, rh,
                                 steps, batch, hidden, device, s, info);
  }
  return kErrBadArgument;
}

const char* gru_seq_fwd_error_string(int code) {
  switch (code) {
    case kErrNotCoResident:
      return "no co-resident grid: the batch and hidden size need more "
             "blocks than a cooperative launch can hold";
    case kErrNoCooperative:
      return "device does not support cooperative launches";
    case kErrBadArgument:
      return "bad argument (dtype code or an empty shape)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
