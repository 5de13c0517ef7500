// Whole-sequence masked peephole-LSTM backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_kernels.py
//   _lstm_bwd_kernel        (:347, called by _lstm_bwd_resident, "K2")
//   _lstm_bwd_tiled_kernel  (:456, called by _lstm_bwd_tiled,    "K4")
// Both compute one function ("resident" and "tiled" were the TPU's VMEM
// budget), so they are one kernel here, the backward of lstm_seq_fwd.cu.
//
// Function (gate order i, f, g, o), for t = T-1 down to 0, per row:
//   z      = gates_t + hprev_t . W_rec              (f32 accumulation)
//   i, f   = sigmoid(z_{i,f} + cprev_t * peep_{i,f}); g = tanh(z_g)
//   c_new  = f * cprev_t + i * g                    (recomputed in f32)
//   o      = sigmoid(z_o + c_new * peep_o)
//   tc     = tanh(c_seq_t)                          (c_t AS STORED)
//   dh_tot = dh_seq_t + dh_carry;  m = mask_t > 0
//   dh_eff = m ? dh_tot : 0
//   dz_o   = dh_eff * tc * o (1 - o)
//   dc_eff = (m ? dc_carry : 0) + dh_eff * o (1 - tc^2) + dz_o * peep_o
//   dz_i   = dc_eff * g * i (1 - i);  dz_f = dc_eff * cprev_t * f (1 - f)
//   dz_g   = dc_eff * i (1 - g^2)
//   dgates_t = dz (stored in the gates' dtype, which is W's dtype)
//   dh_carry = (m ? 0 : dh_tot) + round(dz) . W_rec^T
//   dc_carry = dc_eff * f + dz_i * peep_i + dz_f * peep_f + (m ? 0 : dc_carry)
//   dpeep   += (sum over rows) [dz_i * cprev, dz_f * cprev, dz_o * c_new]
// dh0, dc0 are the final carries (gates' dtype); dpeep is f32. The weight
// gradient hprev^T . dgates is one large GEMM the caller runs outside.
//
// Design: ONE cooperative launch per sequence over a persistent grid, as
// the forward. Block (unit tile, batch tile) owns 32 hidden units (one per
// lane) x R batch rows for the whole sequence; warp r keeps row r's
// dh/dc carries and dpeep partial sums of its 32 units in registers. Per
// step a block
//   (a) recomputes z for its 4 x 32 gate columns from hprev_t, which the
//       forward saved (read-only here: no dependence between blocks): the
//       hprev rows are staged in shared memory and K = H is split over the
//       8 warps, each summing its K slice in f32 on CUDA cores, reading W's
//       column slice [H, 128] from shared memory when it fits ("column
//       resident") or from L2; the partial sums are reduced in a fixed order,
//   (b) runs the cell backward for its units and rows (carries in
//       registers, inputs of step t prefetched at the start of the step) and
//       writes dz to dgates_t,
//   (c) waits at the grid barrier (dz of every gate column is needed next),
//   (d) forms the dh carry of its own units: dz_t rows of its batch tile
//       are staged through shared memory in chunks of 1024 columns (L2-only
//       loads: other blocks wrote them this step) and K = 4H is split over
//       the warps against W's row slice [32, 4H], from shared memory when it
//       fits ("row resident") or from L2. The caller passes W transposed
//       as well ([4H, H]): the row slice is a column slice of W^T, so a
//       warp's loads of it are coalesced, as in (a).
// Because (d) writes only the block's own units, the next step's (b) needs
// no second barrier: one grid barrier per step. dpeep's per-row partials
// are reduced inside the block in row order and written to
// dpeep_part[first row of the tile, 3, H]; the caller sums that small
// tensor over its rows (no float atomics: the result is deterministic).
// The host picks R and the W placement so that the grid is co-resident
// (both slices resident, then the column slice, then neither; resident
// with the smallest R that fits, L2 with the largest), and splits a batch
// too large for one co-resident grid into equal row chunks, one launch
// each, in stream order.
//
// What bounds it on this card: as the forward, the T steps are serially
// dependent and one step's two GEMVs ([R, H] x [H, 128] and [R, 4H] x
// [4H, 32] per block) are far too small to fill the card, so time is set by
// per-step latency (the hprev staging, the K loops, the grid barrier, the
// dz round trip through L2), not by HBM bytes or peak FLOPs. Resident W
// slices take L2 round trips out of the K loops, the K split over 8 warps
// cuts each loop's length by 8, and the per-step inputs are fetched before
// the loops so that their latency hides behind them. At H=1280 both W
// slices stream from L2 every step; cp.async/TMA staging of those, tensor
// cores, and overlapping (a) of step t-1 with the barrier of step t come
// next.

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
constexpr int kCols = 4 * kUnits;  // gate columns per block (i, f, g, o)
constexpr int kWarps = 8;          // K is split over the warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKPad = 4;      // K is padded to a multiple of this (float4)
constexpr int kChunk = 1024;  // dz columns staged per pass of (d)
// staging pitch floor: the partial-sum buffers alias the staging buffer
// and need kWarps * 4 * 32 floats per row
constexpr int kStageMin = kWarps * 4 * kUnits;

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

// inputs that no block writes: through the non-coherent cache
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// dgates is written by other blocks during the launch: read it from L2
// (cache-global), never from a possibly stale L1 line
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

__host__ __device__ constexpr int wcol_bytes(int kpad, int elem_bytes) {
  return round_up(kpad * kCols * elem_bytes, 16);
}

__host__ __device__ constexpr int wrow_bytes(int hidden, int elem_bytes) {
  return round_up(4 * hidden * kUnits * elem_bytes, 16);
}

// W in L2: ask for 3 blocks per SM, so that a 64 x 1280 batch tile grid
// (320 blocks of R = 8) stays co-resident on 132 SMs
template <typename T, int R, bool kColRes, bool kRowRes>
__global__ void __launch_bounds__(kThreads, kColRes ? 1 : 3)
lstm_seq_bwd_kernel(const T* __restrict__ gates,
                    const float* __restrict__ mask,
                    const T* __restrict__ w_rec,
                    const T* __restrict__ w_t,
                    const float* __restrict__ peep,
                    const T* __restrict__ hprev, const T* __restrict__ cprev,
                    const T* __restrict__ c_seq,
                    const T* __restrict__ dh_seq,
                    const T* __restrict__ dh_f, const T* __restrict__ dc_f,
                    T* dgates, T* __restrict__ dh0, T* __restrict__ dc0,
                    float* __restrict__ dpeep_part, int steps, int batch,
                    int stride, int hidden, int unit_tiles, int row_base) {
  // batch: the rows of this launch; stride: the rows of the whole batch,
  // the pitch of every [T, B, ...] array (the pointers start at this
  // launch's first row, which is row ``row_base`` of the whole batch)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int kpad = round_up(hidden, kKPad);
  const int sp = stage_pitch(kpad);
  const int g4 = 4 * hidden;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = (blockIdx.x % unit_tiles) * kUnits;
  const int u = u0 + lane;
  const int b0 = (blockIdx.x / unit_tiles) * R;
  const bool u_ok = u < hidden;
  // this warp's K slice of (a)
  const int ks = round_up((kpad + kWarps - 1) / kWarps, kKPad);
  const int k_begin = min(kpad, warp * ks);
  const int k_end = min(kpad, k_begin + ks);
  // this warp's own row (warp r owns row r of the tile)
  const int b = b0 + warp;
  const bool owner = warp < R && u_ok && b < batch;

  // shared memory: [W columns (column resident)] [W rows (row resident)]
  //                [staging R x sp floats: hprev rows in (a), dz rows in
  //                 (d), and the partial sums of both]
  T* wc = reinterpret_cast<T*>(smem_raw);
  T* wr = reinterpret_cast<T*>(
      smem_raw + (kColRes ? wcol_bytes(kpad, static_cast<int>(sizeof(T)))
                          : 0));
  float* st = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(wr) +
      (kRowRes ? wrow_bytes(hidden, static_cast<int>(sizeof(T))) : 0));
  if (kColRes) {  // wc[k][q * 32 + l] = W[k, q * H + u0 + l]
    for (int e = threadIdx.x; e < kpad * kCols; e += kThreads) {
      const int k = e / kCols;
      const int j = e % kCols;
      const int uu = u0 + j % kUnits;
      wc[e] = (k < hidden && uu < hidden)
                  ? w_rec[static_cast<size_t>(k) * g4 + (j / kUnits) * hidden +
                          uu]
                  : from_f<T>(0.f);
    }
  }
  if (kRowRes) {  // wr[j][l] = W[u0 + l, j] = W^T[j, u0 + l]
    for (int e = threadIdx.x; e < g4 * kUnits; e += kThreads) {
      const int j = e / kUnits;
      const int uu = u0 + e % kUnits;
      wr[e] = uu < hidden ? w_t[static_cast<size_t>(j) * hidden + uu]
                          : from_f<T>(0.f);
    }
  }

  float pi = 0.f, pf = 0.f, po = 0.f;
  float dh_c = 0.f, dc_c = 0.f, dh_pass = 0.f;
  float dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;
  if (owner) {
    pi = peep[u];
    pf = peep[hidden + u];
    po = peep[2 * hidden + u];
    const size_t o = static_cast<size_t>(b) * hidden + u;
    dh_c = to_f(dh_f[o]);
    dc_c = to_f(dc_f[o]);
  }
  __syncthreads();  // resident W slices complete

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row_t = static_cast<size_t>(t) * stride;
    // this step's per-row inputs, fetched ahead of the K loop
    float zg[4] = {0.f, 0.f, 0.f, 0.f};
    float cp = 0.f, cs = 0.f, dhs = 0.f, mk = 0.f;
    if (owner) {
      const T* g = gates + (row_t + b) * g4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) zg[q] = load_ro(g + q * hidden);
      const size_t o = (row_t + b) * hidden + u;
      cp = load_ro(cprev + o);
      cs = load_ro(c_seq + o);
      dhs = load_ro(dh_seq + o);
      mk = mask[row_t + b];
    }
    // (a) stage hprev_t rows of this batch tile (zero past H and past B)
    for (int e = threadIdx.x; e < R * kpad; e += kThreads) {
      const int r = e / kpad;
      const int k = e % kpad;
      const int bb = b0 + r;
      st[r * sp + k] =
          (bb < batch && k < hidden)
              ? load_ro(hprev + (row_t + bb) * hidden + k)
              : 0.f;
    }
    __syncthreads();
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
            if (kColRes) {
              w[kk][q] = to_f(wc[(k + kk) * kCols + q * kUnits + lane]);
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
          const float4 hv = *reinterpret_cast<const float4*>(st + r * sp + k);
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
    __syncthreads();  // every warp is done with the staged rows
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st[((warp * 4 + q) * R + r) * kUnits + lane] = acc[q][r];
      }
    }
    __syncthreads();
    // (b) owners reduce the partials (fixed order) and run the cell backward
    if (owner) {
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s += st[((w * 4 + q) * R + warp) * kUnits + lane];
        }
        z[q] = zg[q] + s;
      }
      const float ig = sigmoidf(z[0] + cp * pi);
      const float fg = sigmoidf(z[1] + cp * pf);
      const float gg = tanhf(z[2]);
      const float cn = fg * cp + ig * gg;
      const float og = sigmoidf(z[3] + cn * po);
      const float tc = tanhf(cs);
      const bool live = mk > 0.f;
      const float dh_tot = dhs + dh_c;
      const float dh_eff = live ? dh_tot : 0.f;
      const float dzo = dh_eff * tc * og * (1.f - og);
      const float dc_eff = (live ? dc_c : 0.f) +
                           dh_eff * og * (1.f - tc * tc) + dzo * po;
      const float dzi = dc_eff * gg * ig * (1.f - ig);
      const float dzf = dc_eff * cp * fg * (1.f - fg);
      const float dzg = dc_eff * ig * (1.f - gg * gg);
      T* dg = dgates + (row_t + b) * g4 + u;
      dg[0] = from_f<T>(dzi);
      dg[hidden] = from_f<T>(dzf);
      dg[2 * hidden] = from_f<T>(dzg);
      dg[3 * hidden] = from_f<T>(dzo);
      dh_pass = live ? 0.f : dh_tot;
      dc_c = dc_eff * fg + dzi * pi + dzf * pf + (live ? 0.f : dc_c);
      dp0 += dzi * cp;
      dp1 += dzf * cp;
      dp2 += dzo * cn;
    }
    // (c) dz of every gate column complete everywhere
    grid.sync();
    // (d) dh carry of this block's units: round(dz_t) . W[u, :]^T
    float dacc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dacc[r] = 0.f;
    for (int c0 = 0; c0 < g4; c0 += kChunk) {
      const int cw = min(kChunk, g4 - c0);
      for (int e = threadIdx.x; e < R * cw; e += kThreads) {
        const int r = e / cw;
        const int j = e % cw;
        const int bb = b0 + r;
        st[r * sp + j] =
            bb < batch ? load_cg(dgates + (row_t + bb) * g4 + c0 + j) : 0.f;
      }
      __syncthreads();
      const int js = round_up((cw + kWarps - 1) / kWarps, 4);
      const int j_begin = min(cw, warp * js);
      const int j_end = min(cw, j_begin + js);
      if (u_ok) {
        for (int j = j_begin; j < j_end; j += 4) {
          float4 wv;
          if (kRowRes) {
            const T* p = wr + (c0 + j) * kUnits + lane;
            wv = make_float4(to_f(p[0]), to_f(p[kUnits]), to_f(p[2 * kUnits]),
                             to_f(p[3 * kUnits]));
          } else {
            const T* p = w_t + static_cast<size_t>(c0 + j) * hidden + u;
            wv = make_float4(load_ro(p), load_ro(p + hidden),
                             load_ro(p + 2 * hidden), load_ro(p + 3 * hidden));
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 dv =
                *reinterpret_cast<const float4*>(st + r * sp + j);
            dacc[r] = fmaf(dv.x, wv.x, dacc[r]);
            dacc[r] = fmaf(dv.y, wv.y, dacc[r]);
            dacc[r] = fmaf(dv.z, wv.z, dacc[r]);
            dacc[r] = fmaf(dv.w, wv.w, dacc[r]);
          }
        }
      }
      __syncthreads();  // the chunk is consumed before it is overwritten
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      st[(warp * R + r) * kUnits + lane] = dacc[r];
    }
    __syncthreads();
    if (owner) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += st[(w * R + warp) * kUnits + lane];
      }
      dh_c = dh_pass + s;
    }
    __syncthreads();  // partials read before the next step stages hprev
  }

  if (owner) {
    const size_t o = static_cast<size_t>(b) * hidden + u;
    dh0[o] = from_f<T>(dh_c);
    dc0[o] = from_f<T>(dc_c);
  }
  // dpeep: this tile's rows summed in row order
  if (warp < R) {
    st[(0 * R + warp) * kUnits + lane] = owner ? dp0 : 0.f;
    st[(1 * R + warp) * kUnits + lane] = owner ? dp1 : 0.f;
    st[(2 * R + warp) * kUnits + lane] = owner ? dp2 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 3 * kUnits) {
    const int q = threadIdx.x / kUnits;
    const int uu = u0 + lane;
    if (uu < hidden) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s += st[(q * R + r) * kUnits + lane];
      dpeep_part[(static_cast<size_t>(row_base + b0) * 3 + q) * hidden + uu] =
          s;
    }
  }
}

template <typename T, int R, bool kColRes, bool kRowRes>
void* kernel_ptr() {
  return reinterpret_cast<void*>(
      lstm_seq_bwd_kernel<T, R, kColRes, kRowRes>);
}

// mode: 2 = both W slices resident, 1 = the column slice, 0 = neither
template <typename T, int R>
void* pick_mode(int mode) {
  switch (mode) {
    case 2:
      return kernel_ptr<T, R, true, true>();
    case 1:
      return kernel_ptr<T, R, true, false>();
    default:
      return kernel_ptr<T, R, false, false>();
  }
}

template <typename T>
void* pick_kernel(int mode, int rows) {
  switch (rows) {
    case 1:
      return pick_mode<T, 1>(mode);
    case 2:
      return pick_mode<T, 2>(mode);
    case 4:
      return pick_mode<T, 4>(mode);
    default:
      return pick_mode<T, 8>(mode);
  }
}

struct Config {
  int mode;    // W placement, as pick_mode
  int rows;    // batch rows per block
  int chunk;   // batch rows per launch
  int blocks;  // blocks of a full-chunk launch
  int smem;
};

// W placements in order of preference; resident ones with the smallest R
// whose grid is co-resident (most blocks, so the most SMs), W in L2 with
// the largest R up to the batch (each batch tile streams both W slices
// from L2 every step, so fewer tiles move fewer bytes). Returns
// kErrNotCoResident when no grid for ``batch`` rows fits.
template <typename T>
int choose_grid(int batch, int hidden, int sms, int smem_optin,
                Config* out) {
  const int kpad = round_up(hidden, kKPad);
  const int esz = static_cast<int>(sizeof(T));
  const int unit_tiles = (hidden + kUnits - 1) / kUnits;
  const int small_first[] = {1, 2, 4, 8};
  const int large_first[] = {8, 4, 2, 1};
  for (int mode = 2; mode >= 0; --mode) {
    for (int i = 0; i < 4; ++i) {
      const int rows = mode > 0 ? small_first[i] : large_first[i];
      if (mode == 0 && rows > 1 && rows / 2 >= batch) continue;
      const int blocks = unit_tiles * ((batch + rows - 1) / rows);
      const int smem = (mode >= 1 ? wcol_bytes(kpad, esz) : 0) +
                       (mode == 2 ? wrow_bytes(hidden, esz) : 0) +
                       static_cast<int>(sizeof(float)) * rows *
                           stage_pitch(kpad);
      if (smem > smem_optin) continue;
      void* kern = pick_kernel<T>(mode, rows);
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (blocks <= per_sm * sms) {
        *out = {mode, rows, batch, blocks, smem};
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
int launch(int dtype, const void* gates, const void* mask, const void* w_rec,
           const void* w_rec_t, const void* peep, const void* hprev, const void* cprev,
           const void* c_seq, const void* dh_seq, const void* dh_f,
           const void* dc_f, void* dgates, void* dh0, void* dc0,
           void* dpeep_part, int steps, int batch, int hidden, int device,
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
        pick_kernel<T>(cfg.mode, cfg.rows),
        cudaFuncAttributeMaxDynamicSharedMemorySize, cfg.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  info[0] = cfg.blocks;
  info[1] = cfg.rows;
  info[2] = cfg.mode;
  info[3] = cfg.smem;
  info[4] = cfg.chunk;
  info[5] = 0;  // launches made
  const T* w = static_cast<const T*>(w_rec);
  const T* wt = static_cast<const T*>(w_rec_t);
  const float* p = static_cast<const float*>(peep);
  float* dpp = static_cast<float*>(dpeep_part);
  int unit_tiles = (hidden + kUnits - 1) / kUnits;
  int stride = batch;
  for (int row0 = 0; row0 < batch; row0 += cfg.chunk) {
    int rows = std::min(cfg.chunk, batch - row0);
    const size_t hb = static_cast<size_t>(row0) * hidden;
    const T* g = static_cast<const T*>(gates) + 4 * hb;
    const float* m = static_cast<const float*>(mask) + row0;
    const T* hp = static_cast<const T*>(hprev) + hb;
    const T* cp = static_cast<const T*>(cprev) + hb;
    const T* cs = static_cast<const T*>(c_seq) + hb;
    const T* dhs = static_cast<const T*>(dh_seq) + hb;
    const T* dhf = static_cast<const T*>(dh_f) + hb;
    const T* dcf = static_cast<const T*>(dc_f) + hb;
    T* dg = static_cast<T*>(dgates) + 4 * hb;
    T* dh = static_cast<T*>(dh0) + hb;
    T* dc = static_cast<T*>(dc0) + hb;
    int base = row0;
    void* args[] = {&g,  &m,  &w,  &wt,  &p,    &hp,   &cp,    &cs,
                    &dhs, &dhf, &dcf, &dg,   &dh,   &dc,    &dpp,
                    &steps, &rows, &stride, &hidden, &unit_tiles, &base};
    const int blocks = unit_tiles * ((rows + cfg.rows - 1) / cfg.rows);
    cudaError_t err = cudaLaunchCooperativeKernel(
        pick_kernel<T>(cfg.mode, cfg.rows), dim3(blocks), dim3(kThreads),
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

// dtype: 0 = float32, 1 = bfloat16 (gates, w_rec, w_rec_t, hprev, cprev,
// c_seq, dh_seq, dh_f, dc_f, dgates, dh0, dc0); mask, peep and dpeep_part
// are float32. w_rec_t is w_rec transposed, [4H, H] contiguous. dpeep_part is [B, 3, H], zero-filled by the caller: each batch
// tile writes its partial sums at the row of its first batch row, and the
// caller sums it over B. info receives {blocks of a full-chunk launch,
// batch rows per block, W placement (2 both slices resident, 1 the column
// slice, 0 neither), dynamic shared memory bytes, batch rows per launch,
// launches made}.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int lstm_seq_bwd(int dtype, const void* gates, const void* mask,
                 const void* w_rec, const void* w_rec_t, const void* peep,
                 const void* hprev, const void* cprev, const void* c_seq,
                 const void* dh_seq, const void* dh_f, const void* dc_f,
                 void* dgates, void* dh0, void* dc0, void* dpeep_part,
                 int steps, int batch, int hidden, int device, void* stream,
                 int* info) {
  if (steps < 1 || batch < 1 || hidden < 1) return kErrBadArgument;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(dtype, gates, mask, w_rec, w_rec_t, peep, hprev,
                         cprev, c_seq, dh_seq, dh_f, dc_f, dgates, dh0, dc0,
                         dpeep_part, steps, batch, hidden, device, s, info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(dtype, gates, mask, w_rec, w_rec_t, peep,
                                 hprev, cprev, c_seq, dh_seq, dh_f, dc_f,
                                 dgates, dh0, dc0, dpeep_part, steps, batch,
                                 hidden, device, s, info);
  }
  return kErrBadArgument;
}

const char* lstm_seq_bwd_error_string(int code) {
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
