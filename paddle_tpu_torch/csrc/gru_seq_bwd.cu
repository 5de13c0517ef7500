// Whole-sequence masked GRU backward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_kernels.py
//   _gru_bwd_kernel  (:724, called by _gru_bwd :773, "K6")
// the backward of gru_seq_fwd.cu.
//
// Function (gate column order u, r, c), for t = T-1 down to 0, per row,
// with h = hprev_t (the saved h_{t-1}) in f32:
//   u, r   = sigmoid(proj_{u,r} + h . W_rz)           (recomputed, f32)
//   rh     = round(r * h)                              (input dtype)
//   c      = tanh(proj_c + rh . W_c)                   (recomputed, f32)
//   dh_tot = dh_seq_t + dh_carry;  m = mask_t > 0;  dh_eff = m ? dh_tot : 0
//   du     = dh_eff * (h - c);   dzc = dh_eff * (1 - u) * (1 - c^2)
//   drh    = round(dzc) . W_c^T
//   dzu    = du * u (1 - u);     dzr = drh * h * r (1 - r)
//   dproj_t  = [dzu, dzr, dzc]                         (input dtype)
//   dh_carry = dh_eff * u + drh * r + round([dzu, dzr]) . W_rz^T
//              + (m ? 0 : dh_tot)                      (carried in f32)
// dh0 is the final carry (input dtype). The weight gradients
// hprev^T . dproj_{u,r} and (r * hprev)^T . dproj_c are large GEMMs the
// caller runs outside, as the JAX VJP leaves them to XLA.
//
// Design: ONE cooperative launch per sequence over a persistent grid, the
// skeleton of lstm_seq_bwd.cu. Block (unit tile, batch tile) owns 32
// hidden units (one per lane) x R batch rows; warp r keeps row r's dh
// carry and the step's u, r, c, h of its 32 units in registers. A GRU step
// needs three exchanges between blocks: rh of every unit (the candidate
// sums over all units), dzc of every unit (for drh), and [dzu, dzr] of
// every unit (for the dh carry). The recompute of u, r and rh for step t-1
// reads only the saved hprev, so it is moved ahead, into step t, before
// the barrier that publishes [dzu, dzr]: TWO grid barriers per step.
//   prologue: (a0) for t = T-1: stage hprev_t rows, the u and r columns
//             against W_rz's column slice [H, 64], rh of the block's units
//             to the scratch rows rh [B, H]; grid barrier.
//   per step: (a1) stage the rh rows (L2-only loads), the c column against
//                  W_c's column slice [H, 32]: c,
//             (b)  cell backward: dzc to dproj_t, dzu and the local terms
//                  of the dh carry in registers; grid barrier (B),
//             (d)  stage the dzc rows of dproj_t, drh of the block's units
//                  against W_c's row slice (a column slice of W_c^T),
//             (e)  dzr; dzu and dzr to dproj_t,
//             (a0) for t-1, as in the prologue (everyone read rh before B),
//                  grid barrier (C),
//             (g)  stage the dzu, then the dzr rows of dproj_t, the dh
//                  carry of the block's units against W_rz's row slice (a
//                  column slice of W_rz^T), as two K loops over H.
// Because (g) writes only the block's own carry and (a1) of the next step
// reads the rh that (a0) published before C, the step needs no third
// barrier. The caller passes W_rz and W_c transposed as well: their row
// slices are then column slices, so a warp's loads of them are coalesced
// like those of the column slices. The host picks R and the W placement
// so that the grid is co-resident (all four slices resident, then the two
// column slices, then none; resident with the smallest R that fits, L2
// with the largest), and splits a batch too large for one co-resident
// grid into equal row chunks, one launch each, in stream order.
//
// What bounds it on this card: as the forward, the T steps are serially
// dependent and one step's GEMVs ([R, H] x [H, 64], [R, H] x [H, 32],
// [R, H] x [H, 32] and [R, 2H] x [2H, 32] per block) are far too small to
// fill the card, so time is set by per-step latency: five staging round
// trips, five K loops and two grid barriers per step. Resident W slices
// (H x 192 values per block: 192 KB at H=256 f32) take the L2 round trips
// out of the K loops and the K split over 8 warps cuts each loop by 8.
// Saving rh (or u, r, c) from the forward would drop the recompute from
// the step; fewer batch tiles and tensor cores for bf16 come next.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 32;           // hidden units per block: one per lane
constexpr int kRzCols = 2 * kUnits;  // W_rz columns per block (u, r)
constexpr int kWarps = 8;            // K is split over the warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kKPad = 4;  // K is padded to a multiple of this (float4)
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

// inputs that no block writes: through the non-coherent cache
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// dproj and the rh scratch are written by other blocks during the launch:
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

// column slices: W_rz [kpad, 64] then W_c [kpad, 32]
__host__ __device__ constexpr int wcol_bytes(int kpad, int elem_bytes) {
  return round_up(kpad * (kRzCols + kUnits) * elem_bytes, 16);
}

// row slices: W_c rows [kpad, 32] then the W_rz rows of dzu and of dzr,
// [kpad, 32] each (zero past H, so the K loops run over kpad)
__host__ __device__ constexpr int wrow_bytes(int kpad, int elem_bytes) {
  return round_up(3 * kpad * kUnits * elem_bytes, 16);
}

// Stage ``width`` columns of rows [b0, b0 + R) of ``src`` (row pitch
// ``pitch``) into st[r * sp + j] as f32, zero from ``valid`` columns on
// and past the launch's rows. ``kCg``: the rows are written during the
// launch (L2-only loads).
template <typename T, int R, bool kCg>
__device__ __forceinline__ void stage_rows(float* st, const T* src,
                                           size_t pitch, int b0, int batch,
                                           int width, int valid, int sp) {
  for (int e = threadIdx.x; e < R * width; e += kThreads) {
    const int r = e / width;
    const int j = e % width;
    const int bb = b0 + r;
    float v = 0.f;
    if (bb < batch && j < valid) {
      const T* p = src + static_cast<size_t>(bb) * pitch + j;
      v = kCg ? load_cg(p) : load_ro(p);
    }
    st[r * sp + j] = v;
  }
}

// One warp's share of a block GEMV: acc[q][r] += sum over its slice of k
// of st[r * sp + k] * w(k, q), for Q weight columns per lane.
template <typename T, int R, int Q, bool kRes>
__device__ __forceinline__ void gemv_slice(
    float (&acc)[Q][R], const float* st, int sp, int k_begin, int k_end,
    int k_valid, const T* ws, int ws_pitch, const T* wg, size_t wg_pitch,
    int wg_col_step, int lane, int u) {
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.f;
  }
  for (int k = k_begin; k < k_end; k += 4) {
    float w[4][Q];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (kRes) {
          w[kk][q] = to_f(ws[(k + kk) * ws_pitch + q * kUnits + lane]);
        } else {
          w[kk][q] = k + kk < k_valid
                         ? load_ro(wg + static_cast<size_t>(k + kk) * wg_pitch +
                                   q * wg_col_step + u)
                         : 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(st + r * sp + k);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        acc[q][r] = fmaf(hv.x, w[0][q], acc[q][r]);
        acc[q][r] = fmaf(hv.y, w[1][q], acc[q][r]);
        acc[q][r] = fmaf(hv.z, w[2][q], acc[q][r]);
        acc[q][r] = fmaf(hv.w, w[3][q], acc[q][r]);
      }
    }
  }
}

// Write each warp's partials into the staging area (after every warp is
// done reading it) and return, for owners, the fixed-order sum over the
// warps of column q for the warp's own row.
template <int R, int Q>
__device__ __forceinline__ void reduce_partials(const float (&acc)[Q][R],
                                                float* st, bool owner,
                                                float (&out)[Q]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // every warp is done with the staged rows
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      st[((warp * Q + q) * R + r) * kUnits + lane] = acc[q][r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float s = 0.f;
    if (owner) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += st[((w * Q + q) * R + warp) * kUnits + lane];
      }
    }
    out[q] = s;
  }
  __syncthreads();  // partials read before the area is staged again
}

// W in L2: ask for 3 blocks per SM, so that wide grids stay co-resident
template <typename T, int R, bool kColRes, bool kRowRes>
__global__ void __launch_bounds__(kThreads, kColRes ? 1 : 3)
gru_seq_bwd_kernel(const T* __restrict__ proj, const float* __restrict__ mask,
                   const T* __restrict__ w_rz, const T* __restrict__ w_c,
                   const T* __restrict__ w_rz_t, const T* __restrict__ w_c_t,
                   const T* __restrict__ hprev, const T* __restrict__ dh_seq,
                   const T* __restrict__ dh_f, T* dproj, T* __restrict__ dh0,
                   T* rh, int steps, int batch, int stride, int hidden,
                   int unit_tiles) {
  // batch: the rows of this launch; stride: the rows of the whole batch,
  // the pitch of every [T, B, ...] array (the pointers start at this
  // launch's first row; dh_f, dh0 and rh are [B, H] from that row)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int kpad = round_up(hidden, kKPad);
  const int sp = stage_pitch(kpad);
  const int g3 = 3 * hidden;
  const int h2 = 2 * hidden;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = (blockIdx.x % unit_tiles) * kUnits;
  const int u = u0 + lane;
  const int b0 = (blockIdx.x / unit_tiles) * R;
  const bool u_ok = u < hidden;
  // this warp's K slice of the GEMVs over H
  const int ks = round_up((kpad + kWarps - 1) / kWarps, kKPad);
  const int k_begin = u_ok ? min(kpad, warp * ks) : 0;
  const int k_end = u_ok ? min(kpad, k_begin + ks) : 0;
  // this warp's own row (warp r owns row r of the tile)
  const int b = b0 + warp;
  const bool owner = warp < R && u_ok && b < batch;

  // shared memory: [W_rz columns, W_c columns (column resident)]
  //                [W_c rows, W_rz rows (row resident)]
  //                [staging R x sp floats, also the partial sums]
  T* wrz_c = reinterpret_cast<T*>(smem_raw);
  T* wc_c = wrz_c + kpad * kRzCols;
  T* wc_r = reinterpret_cast<T*>(
      smem_raw + (kColRes ? wcol_bytes(kpad, static_cast<int>(sizeof(T)))
                          : 0));
  T* wrz_r = wc_r + kpad * kUnits;
  float* st = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(wc_r) +
      (kRowRes ? wrow_bytes(kpad, static_cast<int>(sizeof(T))) : 0));
  if (kColRes) {
    // wrz_c[k][q * 32 + l] = W_rz[k, q * H + u0 + l]
    for (int e = threadIdx.x; e < kpad * kRzCols; e += kThreads) {
      const int k = e / kRzCols;
      const int j = e % kRzCols;
      const int uu = u0 + j % kUnits;
      wrz_c[e] = (k < hidden && uu < hidden)
                     ? w_rz[static_cast<size_t>(k) * h2 +
                            (j / kUnits) * hidden + uu]
                     : from_f<T>(0.f);
    }
    // wc_c[k][l] = W_c[k, u0 + l]
    for (int e = threadIdx.x; e < kpad * kUnits; e += kThreads) {
      const int k = e / kUnits;
      const int uu = u0 + e % kUnits;
      wc_c[e] = (k < hidden && uu < hidden)
                    ? w_c[static_cast<size_t>(k) * hidden + uu]
                    : from_f<T>(0.f);
    }
  }
  if (kRowRes) {
    // wc_r[i][l] = W_c[u0 + l, i] = W_c^T[i, u0 + l]
    for (int e = threadIdx.x; e < kpad * kUnits; e += kThreads) {
      const int i = e / kUnits;
      const int uu = u0 + e % kUnits;
      wc_r[e] = (i < hidden && uu < hidden)
                    ? w_c_t[static_cast<size_t>(i) * hidden + uu]
                    : from_f<T>(0.f);
    }
    // wrz_r[half][j][l] = W_rz[u0 + l, half * H + j]
    //                   = W_rz^T[half * H + j, u0 + l]
    for (int e = threadIdx.x; e < 2 * kpad * kUnits; e += kThreads) {
      const int half = e / (kpad * kUnits);
      const int j = (e / kUnits) % kpad;
      const int uu = u0 + e % kUnits;
      wrz_r[e] = (j < hidden && uu < hidden)
                     ? w_rz_t[static_cast<size_t>(half * hidden + j) * hidden +
                              uu]
                     : from_f<T>(0.f);
    }
  }
  const size_t bh = static_cast<size_t>(stride) * hidden;
  const size_t bg = static_cast<size_t>(stride) * g3;

  float dh_c = 0.f;
  if (owner) dh_c = to_f(dh_f[static_cast<size_t>(b) * hidden + u]);
  __syncthreads();  // resident W slices complete

  // (a0): u and r of step t for the block's units, rh out; returns them in
  // ug, rg and the row's h_{t-1} in hg (owners)
  auto recompute_ur = [&](int t, float& ug, float& rg, float& hg) {
    stage_rows<T, R, false>(st, hprev + t * bh, hidden, b0, batch, kpad,
                            hidden, sp);
    __syncthreads();
    float acc[2][R];
    gemv_slice<T, R, 2, kColRes>(acc, st, sp, k_begin, k_end, hidden, wrz_c,
                                 kRzCols, w_rz, h2, hidden, lane, u);
    float s[2];
    reduce_partials<R, 2>(acc, st, owner, s);
    if (owner) {
      const size_t row = static_cast<size_t>(t) * stride + b;
      const T* p = proj + row * g3 + u;
      ug = sigmoidf(load_ro(p) + s[0]);
      rg = sigmoidf(load_ro(p + hidden) + s[1]);
      hg = load_ro(hprev + row * hidden + u);
      rh[static_cast<size_t>(b) * hidden + u] = from_f<T>(rg * hg);
    }
  };

  float ug = 0.f, rg = 0.f, hg = 0.f;
  recompute_ur(steps - 1, ug, rg, hg);
  grid.sync();  // rh of step T-1 complete

  for (int t = steps - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * stride + b;
    // this step's per-row inputs, fetched ahead of the K loop
    float xc = 0.f, dhs = 0.f, mk = 0.f;
    if (owner) {
      xc = load_ro(proj + row * g3 + h2 + u);
      dhs = to_f(dh_seq[row * hidden + u]);
      mk = mask[row];
    }
    // (a1) the candidate from the published rh rows
    stage_rows<T, R, true>(st, rh, hidden, b0, batch, kpad, hidden, sp);
    __syncthreads();
    float acc1[1][R];
    gemv_slice<T, R, 1, kColRes>(acc1, st, sp, k_begin, k_end, hidden, wc_c,
                                 kUnits, w_c, hidden, 0, lane, u);
    float s1[1];
    reduce_partials<R, 1>(acc1, st, owner, s1);
    // (b) cell backward: dzc out, the local terms of the dh carry
    float dzu = 0.f, dh_part = 0.f;
    if (owner) {
      const float cg_ = tanhf(xc + s1[0]);
      const bool live = mk > 0.f;
      const float dh_tot = dhs + dh_c;
      const float dh_eff = live ? dh_tot : 0.f;
      const float du = dh_eff * (hg - cg_);
      const float dzc = dh_eff * (1.f - ug) * (1.f - cg_ * cg_);
      dzu = du * ug * (1.f - ug);
      dh_part = dh_eff * ug + (live ? 0.f : dh_tot);
      dproj[row * g3 + h2 + u] = from_f<T>(dzc);
    }
    grid.sync();  // (B) dzc of every unit complete
    // (d) drh = round(dzc) . W_c^T for the block's units
    stage_rows<T, R, true>(st, dproj + t * bg + h2, g3, b0, batch, kpad,
                           hidden, sp);
    __syncthreads();
    gemv_slice<T, R, 1, kRowRes>(acc1, st, sp, k_begin, k_end, hidden, wc_r,
                                 kUnits, w_c_t, hidden, 0, lane, u);
    reduce_partials<R, 1>(acc1, st, owner, s1);
    // (e) dzr; dzu and dzr out
    if (owner) {
      const float drh = s1[0];
      const float dzr = drh * hg * rg * (1.f - rg);
      dh_part += drh * rg;
      dproj[row * g3 + u] = from_f<T>(dzu);
      dproj[row * g3 + hidden + u] = from_f<T>(dzr);
    }
    // (a0) of the next step: every block read this step's rh before (B)
    float ug_n = 0.f, rg_n = 0.f, hg_n = 0.f;
    if (t > 0) recompute_ur(t - 1, ug_n, rg_n, hg_n);
    grid.sync();  // (C) [dzu, dzr] of every unit and the next rh complete
    // (g) the dh carry: round(dzu) . W_rz^T[:H] + round(dzr) . W_rz^T[H:]
    float dacc[1][R];
#pragma unroll
    for (int r = 0; r < R; ++r) dacc[0][r] = 0.f;
    for (int half = 0; half < 2; ++half) {
      stage_rows<T, R, true>(st, dproj + t * bg + half * hidden, g3, b0,
                             batch, kpad, hidden, sp);
      __syncthreads();
      float part[1][R];
      gemv_slice<T, R, 1, kRowRes>(
          part, st, sp, k_begin, k_end, hidden, wrz_r + half * kpad * kUnits,
          kUnits, w_rz_t + static_cast<size_t>(half) * hidden * hidden,
          hidden, 0, lane, u);
#pragma unroll
      for (int r = 0; r < R; ++r) dacc[0][r] += part[0][r];
      __syncthreads();  // the rows are consumed before they are overwritten
    }
    float s2[1];
    reduce_partials<R, 1>(dacc, st, owner, s2);
    if (owner) dh_c = dh_part + s2[0];
    ug = ug_n;
    rg = rg_n;
    hg = hg_n;
  }

  if (owner) dh0[static_cast<size_t>(b) * hidden + u] = from_f<T>(dh_c);
}

template <typename T, int R, bool kColRes, bool kRowRes>
void* kernel_ptr() {
  return reinterpret_cast<void*>(gru_seq_bwd_kernel<T, R, kColRes, kRowRes>);
}

// mode: 2 = all W slices resident, 1 = the column slices, 0 = none
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
// the largest R up to the batch (each batch tile streams the W slices from
// L2 every step, so fewer tiles move fewer bytes). Returns
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
                       (mode == 2 ? wrow_bytes(kpad, esz) : 0) +
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
int launch(int dtype, const void* proj, const void* mask, const void* w_rz,
           const void* w_c, const void* w_rz_t, const void* w_c_t,
           const void* hprev, const void* dh_seq, const void* dh_f,
           void* dproj, void* dh0, void* rh, int steps, int batch, int hidden,
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
  const T* wrz = static_cast<const T*>(w_rz);
  const T* wc = static_cast<const T*>(w_c);
  const T* wrzt = static_cast<const T*>(w_rz_t);
  const T* wct = static_cast<const T*>(w_c_t);
  int unit_tiles = (hidden + kUnits - 1) / kUnits;
  int stride = batch;
  for (int row0 = 0; row0 < batch; row0 += cfg.chunk) {
    int rows = std::min(cfg.chunk, batch - row0);
    const size_t hb = static_cast<size_t>(row0) * hidden;
    const T* p = static_cast<const T*>(proj) + 3 * hb;
    const float* m = static_cast<const float*>(mask) + row0;
    const T* hp = static_cast<const T*>(hprev) + hb;
    const T* dhs = static_cast<const T*>(dh_seq) + hb;
    const T* dhf = static_cast<const T*>(dh_f) + hb;
    T* dp = static_cast<T*>(dproj) + 3 * hb;
    T* dh = static_cast<T*>(dh0) + hb;
    T* rr = static_cast<T*>(rh) + hb;
    void* args[] = {&p,    &m,  &wrz, &wc,    &wrzt,  &wct,    &hp,
                    &dhs,  &dhf, &dp, &dh,    &rr,    &steps,  &rows,
                    &stride, &hidden, &unit_tiles};
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

// dtype: 0 = float32, 1 = bfloat16 (proj, w_rz, w_c, w_rz_t, w_c_t,
// hprev, dh_seq, dh_f, dproj, dh0, rh); mask is float32. w_rz_t and w_c_t
// are w_rz and w_c transposed ([2H, H] and [H, H], contiguous); rh is
// scratch of B*H elements. info receives {blocks of a full-chunk launch,
// batch rows per block, W placement (2 all slices resident, 1 the column
// slices, 0 none), dynamic shared memory bytes, batch rows per launch,
// launches made}.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int gru_seq_bwd(int dtype, const void* proj, const void* mask,
                const void* w_rz, const void* w_c, const void* w_rz_t,
                const void* w_c_t, const void* hprev, const void* dh_seq,
                const void* dh_f, void* dproj, void* dh0, void* rh,
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
    return launch<float>(dtype, proj, mask, w_rz, w_c, w_rz_t, w_c_t, hprev,
                         dh_seq, dh_f, dproj, dh0, rh, steps, batch, hidden,
                         device, s, info);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(dtype, proj, mask, w_rz, w_c, w_rz_t, w_c_t,
                                 hprev, dh_seq, dh_f, dproj, dh0, rh, steps,
                                 batch, hidden, device, s, info);
  }
  return kErrBadArgument;
}

const char* gru_seq_bwd_error_string(int code) {
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
