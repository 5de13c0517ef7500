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
// Two layouts, picked by the caller's planner (ops/gru_kernels.
// gru_bwd_plan) from the shapes and dtype and recorded in info[2]. In both
// the T steps are serially dependent, and no float atomics are used: every
// sum runs in a fixed order, so a repeat is the same bit for bit.
//
// UNIT TILES (H % 8 != 0, or a width whose cluster does not fit). ONE
// cooperative launch per sequence over a persistent grid, the skeleton of
// lstm_seq_bwd.cu's unit tiles. Block (unit tile, batch tile) owns 32
// hidden units (one per lane) x R batch rows; warp r keeps row r's dh
// carry and the step's u, r, c, h of its 32 units in registers. A step
// needs three exchanges between blocks: rh of every unit (the candidate
// sums over all units), dzc of every unit (for drh), and [dzu, dzr] of
// every unit (for the dh carry). The recompute of u, r and rh for step t-1
// reads only the saved hprev, so it runs inside step t, before the barrier
// that publishes [dzu, dzr]: TWO grid barriers per step.
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
// The caller passes W_rz and W_c transposed as well (row slices as column
// slices, read coalesced). The host picks R and the W placement so that the
// grid is co-resident (all four slices resident, then the two column
// slices, then none) and splits a batch too large for one co-resident grid
// into equal row chunks, one launch each. Bound on this card: per-step
// latency, not arithmetic: five staging round trips through L2, five K
// loops (three of them the recompute) and two grid barriers over every
// block (at (128, 64, 256) 10.5 us a step). The cluster layout takes the
// recompute out of the loop and the exchanges off L2; this layout stays
// for the widths it cannot take.
//
// CLUSTERS (K6: H % 8 == 0, H <= 32 x 16, both W row slices resident).
// Batch rows never exchange anything; only the units of one row do. So
// each batch tile is ONE thread-block cluster of ceil(H / 32) blocks (8 at
// H=256; above 8 a non-portable size, up to 16), one per unit tile, and
// clusters never wait for each other (no cooperative launch). Before the
// launch the recompute runs as two GEMM passes over all T * B rows
// (seq_recompute.cuh: bfloat16 on the tensor cores, float32 on the CUDA
// cores; sums in f32): [T*B, H] x W_rz [H, 2H] + proj_{u,r}
// gives u, r (float32 workspace) and rh = round(r * hprev) (proj's dtype);
// then rh x W_c [H, H] + proj_c gives c (float32 workspace). A block keeps
// W_c's and W_rz's row slices resident (96 KB float32 at H=256) for the
// whole sequence and, in clusters of at most 8 blocks, in registers
// (float32: a thread's columns and units; bfloat16: the B fragments of
// mma.sync.m16n8k16). Per step:
//   (C1) the cell backward of its R rows x 32 units from u, r, c, h (the
//        step's inputs fetched one step ahead, two where (D1) and (D2) run
//        on the tensor cores): dzc to dproj_t and round(dzc) into EVERY
//        block's first exchange buffer (distributed shared memory; float32,
//        so that (D1) widens nothing), dzu and the local terms of the dh
//        carry in registers;
//   (A)  cluster barrier;
//   (D1) drh of its 32 units: round(dzc) . W_c^T over H from local shared
//        memory, K split over the 8 warps, partials reduced in warp order
//        (float32 FMA on the CUDA cores, or bfloat16 on the tensor cores:
//        products of bf16 values are exact in float32);
//   (C2) dzr; dzu and dzr to dproj_t, [round(dzu), round(dzr)] of each unit
//        into every block's second exchange buffer as one vector;
//   (B)  cluster barrier (arrive, the next inputs fetched, wait);
//   (D2) the dh carry: [round(dzu), round(dzr)] . W_rz^T over 2H, the same
//        way (float32: two units' pairs a 16-byte load).
// The two barriers alternate, so each exchange buffer needs one copy: a
// block stores into the first at step t-1 only after barrier B of step t,
// which every peer reaches after (D1) has read it, and into the second
// only after barrier A of step t-1, which every peer reaches after (D2)
// has read it. A cluster barrier before the loop and one before exit frame
// it. R (rows per block: 1, 2, 4, 5 or 8) is the smallest that keeps the
// batch's clusters co-resident, from the card's count of active clusters
// (gru_seq_bwd_limits: 15 of 8 on an H100 SXM, so B=64 runs as 13
// clusters of 5 rows). Bound on this card: the step's serial latency, two
// cluster barriers over 8 SMs a step instead of two grid barriers over
// every block, two block barriers, two exchanges between SMs, and R x 32 x
// 3H FMAs per block in float32; the recompute is two GEMMs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "seq_recompute.cuh"
#include "sm90_cluster.cuh"
#include "sm90_mma.cuh"

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

// ---------------------------------------------------------------------------
// Clusters: the recompute passes, then one thread-block cluster per batch
// tile.

// zbuf [T*B, 3H] float32: u, r, then c; rh [T*B, H] in proj's dtype
template <typename T>
struct UrEpilogue {  // u, r = sigmoid(proj_{u,r} + hprev . W_rz); rh
  const T* proj;
  const T* hprev;
  float* zbuf;
  T* rh;
  int hidden;
  template <int kN>
  __device__ __forceinline__ void operator()(long long row, int col,
                                             const float (&v)[kN]) const {
    const size_t g = static_cast<size_t>(row) * 3 * hidden + col;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float s = sigmoidf(to_f(proj[g + i]) + v[i]);
      zbuf[g + i] = s;
      if (col + i >= hidden) {  // r: rh = round(r * h)
        const size_t o = static_cast<size_t>(row) * hidden + col + i - hidden;
        rh[o] = from_f<T>(s * to_f(hprev[o]));
      }
    }
  }
};

template <typename T>
struct CEpilogue {  // c = tanh(proj_c + rh . W_c)
  const T* proj;
  float* zbuf;
  int hidden;
  template <int kN>
  __device__ __forceinline__ void operator()(long long row, int col,
                                             const float (&v)[kN]) const {
    const size_t g = static_cast<size_t>(row) * 3 * hidden + 2 * hidden + col;
#pragma unroll
    for (int i = 0; i < kN; ++i) zbuf[g + i] = tanhf(to_f(proj[g + i]) + v[i]);
  }
};

// The layout's constants and cl_smem_bytes have a copy in the caller's
// planner (ops/gru_kernels.py, _CL_*), which a CPU test holds equal to
// these.
constexpr int kClMaxTiles = 16;  // unit tiles (blocks) per cluster, at most

// exchange rows are padded by this many floats (32 bytes) in clusters of
// at most 8 blocks (W in registers), so that the tensor-core path's
// fragment loads of 8 rows hit distinct banks
constexpr int kXPad = 8;

__host__ __device__ constexpr int cl_xpad(int hidden) {
  return hidden <= sm90::kPortableClusterSize * kUnits ? kXPad : 0;
}

// Shared memory of a cluster block in bytes: W_c's row slice [H][32] and
// W_rz's [H][32][2] in proj's dtype, then the exchange buffers [R][H +
// pad] (dzc) and [R][2H + pad] (dzu, dzr) (the rounded values in float32, so
// that (D1) and (D2) widen nothing) and the warps' partial sums
// [8][R][32], in float32.
__host__ __device__ constexpr int cl_smem_bytes(int hidden, int rows,
                                                int elem_bytes) {
  return round_up(3 * kUnits * hidden * elem_bytes, 16) +
         rows * (3 * hidden + 2 * cl_xpad(hidden)) *
             static_cast<int>(sizeof(float)) +
         kWarps * rows * kUnits * static_cast<int>(sizeof(float));
}

// kRegW (clusters of at most 8 blocks, H <= 256: a warp's columns of
// (D1) and units of (D2) at most kRegCols): each thread keeps W in
// registers for the sequence, so that (D1) and (D2) read only dz from
// shared memory: in float32 the W values of its columns and units; in
// bfloat16 the B fragments of mma.sync.m16n8k16, both loops then on the
// tensor cores (products of bf16 values are exact in float32). Else they
// read the row slices from shared memory.
constexpr int kRegCols = 32;

template <typename T, int R, bool kRegW>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_cluster(const float* __restrict__ zbuf, const float* __restrict__ mask,
                const T* __restrict__ w_rz, const T* __restrict__ w_c,
                const T* __restrict__ hprev, const T* __restrict__ dh_seq,
                const T* __restrict__ dh_f, T* __restrict__ dproj,
                T* __restrict__ dh0, int steps, int batch, int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kEsz = static_cast<int>(sizeof(T));
  const int g3 = 3 * hidden;
  const int h2 = 2 * hidden;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = gridDim.x;  // the cluster: one block per unit tile
  const int u0 = blockIdx.x * kUnits;
  const int u = u0 + lane;
  const bool u_ok = u < hidden;
  const int b0 = blockIdx.y * R;
  const int b = b0 + warp;  // warp r owns row r of the tile
  const bool owner = warp < R && u_ok && b < batch;
  // this warp's share of (D1) (4 columns at a time) and of (D2) (units,
  // an even count, so that a 16-byte load takes the pairs of two units)
  const int ks = round_up((hidden + kWarps - 1) / kWarps, 4);
  const int i_begin = min(hidden, warp * ks);
  const int i_end = min(hidden, i_begin + ks);
  const int upw = round_up((hidden + kWarps - 1) / kWarps, 2);
  const int k_begin = min(hidden, warp * upw);
  const int k_end = min(hidden, k_begin + upw);
  const int x1p = hidden + cl_xpad(hidden);  // exchange row pitches
  const int x2p = 2 * hidden + cl_xpad(hidden);
  constexpr bool kMma = kRegW && std::is_same<T, __nv_bfloat16>::value;

  // shared memory: wc_r[i * 32 + l] = W_c[u0 + l, i];
  // wrz_r[(k * 32 + l) * 2 + half] = W_rz[u0 + l, half * H + k];
  // x1[r][i] = round(dzc) of row r, unit i (pitch x1p); x2[r][2k + h] =
  // round(dzu) (h = 0), round(dzr) (h = 1) of row r, unit k (pitch x2p;
  // both float32); red[8][R][32]
  T* wc_r = reinterpret_cast<T*>(smem_raw);
  T* wrz_r = wc_r + kUnits * hidden;
  float* x1 = reinterpret_cast<float*>(
      smem_raw + round_up(3 * kUnits * hidden * kEsz, 16));
  float* x2 = x1 + R * x1p;
  float* red = x2 + R * x2p;
  for (int e = threadIdx.x; e < kUnits * hidden; e += kThreads) {
    const int l = e / hidden;  // consecutive threads read one row of W_c
    const int i = e - l * hidden;
    const int uu = u0 + l;
    wc_r[i * kUnits + l] =
        uu < hidden ? w_c[static_cast<size_t>(uu) * hidden + i]
                    : from_f<T>(0.f);
  }
  for (int e = threadIdx.x; e < kUnits * h2; e += kThreads) {
    const int l = e / h2;
    const int j = e - l * h2;
    const int uu = u0 + l;
    wrz_r[((j % hidden) * kUnits + l) * 2 + j / hidden] =
        uu < hidden ? w_rz[static_cast<size_t>(uu) * h2 + j]
                    : from_f<T>(0.f);
  }
  // rows past the batch are never stored: zeros, read and discarded
  for (int e = threadIdx.x; e < R * (x1p + x2p); e += kThreads) x1[e] = 0.f;
  __syncthreads();  // the W slices are complete
  float wc_reg[kRegW && !kMma ? kRegCols : 1];
  float wrz_reg[kRegW && !kMma ? kRegCols : 1][2];
  // the tensor-core path: B fragments (lane (g, t): B[2t, 2t + 1][g],
  // B[2t + 8, 2t + 9][g], sm90_mma.cuh) of B[k][n] = W_c[u0 + nt * 8 + n,
  // i_begin + k] for (D1) and W_rz[u0 + nt * 8 + n, (k % 2) * H + k_begin
  // + k / 2] for (D2), zero past the warp's columns and units
  uint32_t bc[kMma ? kRegCols / 16 : 1][4][2];
  uint32_t brz[kMma ? kRegCols / 8 : 1][4][2];
  if constexpr (kMma) {
    const int t2 = 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = nt * 8 + lane / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int ks = 0; ks < kRegCols / 16; ++ks) {
          const int i = i_begin + ks * 16 + t2 + 8 * h;  // i_end - i_begin
          __nv_bfloat162 p;                             // is a multiple of 4
          p.x = i < i_end ? wc_r[i * kUnits + n] : from_f<T>(0.f);
          p.y = i < i_end ? wc_r[(i + 1) * kUnits + n] : from_f<T>(0.f);
          bc[ks][nt][h] = *reinterpret_cast<const uint32_t*>(&p);
        }
#pragma unroll
        for (int ks = 0; ks < kRegCols / 8; ++ks) {
          const int k = k_begin + (ks * 16 + t2 + 8 * h) / 2;
          brz[ks][nt][h] = k < k_end ? *reinterpret_cast<const uint32_t*>(
                                           wrz_r + (k * kUnits + n) * 2)
                                     : 0u;
        }
      }
    }
  } else if constexpr (kRegW) {
#pragma unroll
    for (int ii = 0; ii < kRegCols; ++ii) {
      wc_reg[ii] = i_begin + ii < i_end
                       ? to_f(wc_r[(i_begin + ii) * kUnits + lane])
                       : 0.f;
      const float2 wv =
          k_begin + ii < k_end
              ? sm90::load2(wrz_r + ((k_begin + ii) * kUnits + lane) * 2)
              : make_float2(0.f, 0.f);
      wrz_reg[ii][0] = wv.x;
      wrz_reg[ii][1] = wv.y;
    }
  }

  float dh_c = 0.f;
  if (owner) dh_c = to_f(dh_f[static_cast<size_t>(b) * hidden + u]);
  // the cell's inputs of a step, fetched kAhead steps ahead: two where (D1)
  // and (D2) run on the tensor cores (so short that a load fetched one
  // step ahead has not landed), into one of two register sets (the loop
  // is unrolled by two, so that no copy waits on a load in flight); one
  // where the CUDA-core loops hide the loads (and unrolling costs more
  // than it saves: measured on the card)
  constexpr int kAhead = kMma ? 2 : 1;
  struct StepIn {
    float u, r, c, h, dhs;
    bool live;
  };
  StepIn in0 = {}, in1 = {};
  auto prefetch = [&](int t, StepIn& in) {
    if (!owner || t < 0) return;
    const size_t row = static_cast<size_t>(t) * batch + b;
    const float* zr = zbuf + row * g3 + u;
    in.u = __ldg(zr);
    in.r = __ldg(zr + hidden);
    in.c = __ldg(zr + h2);
    const size_t o = row * hidden + u;
    in.h = load_ro(hprev + o);
    in.dhs = load_ro(dh_seq + o);
    in.live = mask[row] > 0.f;
  };
  prefetch(steps - 1, in0);
  if (kAhead == 2) prefetch(steps - 2, in1);
  // every peer's shared memory exists, and this block's W slices and
  // zeroed buffers are complete, before anyone stores into a peer
  cluster.sync();

  auto step = [&](int t, StepIn& in) {
    const size_t row = static_cast<size_t>(t) * batch + b;
    // (C1) dzc to dproj_t and to every block of the cluster
    float ug = 0.f, rg = 0.f, hg = 0.f, dzu = 0.f, dh_part = 0.f;
    if (owner) {
      ug = in.u;
      rg = in.r;
      hg = in.h;
      const float cg_ = in.c;
      const bool live = in.live;
      const float dh_tot = in.dhs + dh_c;
      const float dh_eff = live ? dh_tot : 0.f;
      const float du = dh_eff * (hg - cg_);
      const float dzc = dh_eff * (1.f - ug) * (1.f - cg_ * cg_);
      dzu = du * ug * (1.f - ug);
      dh_part = dh_eff * ug + (live ? 0.f : dh_tot);
      const T v = from_f<T>(dzc);
      dproj[row * g3 + h2 + u] = v;
      float* slot = x1 + warp * x1p + u;
      for (int i = 0; i < tiles; ++i) {
        const int rank = (static_cast<int>(blockIdx.x) + i) % tiles;
        *cluster.map_shared_rank(slot, rank) = to_f(v);
      }
    }
    sm90::cluster_sync();  // (A) every unit's round(dzc) has landed
    // (D1) drh = round(dzc) . W_c^T: this warp's columns, R rows
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if constexpr (kMma) {
      // A[g][k] = round(dzc) of row g, column i_begin + k (rows past R and
      // 8-15 zero); k-steps past the warp's columns read the row's first
      // ones against B of zeros
      const int g = lane / 4;
      const float* arow = x1 + min(g, R - 1) * x1p + 2 * (lane % 4);
      float d[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kRegCols / 16; ++ks) {
        const int col = i_begin + ks * 16 < i_end ? i_begin + ks * 16 : 0;
        const uint32_t a[4] = {
            g < R ? sm90::pack_bf16(sm90::load2(arow + col)) : 0u, 0u,
            g < R ? sm90::pack_bf16(sm90::load2(arow + col + 8)) : 0u, 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          sm90::mma_bf16(d[nt], a, bc[ks][nt][0], bc[ks][nt][1]);
        }
      }
      sm90::store_d_rows(d, red + warp * R * kUnits, kUnits, R, lane);
    } else if constexpr (kRegW) {
      // no branch in the unrolled loop, so that its loads run ahead: columns
      // past the warp's range read columns 0-3 against W registers of zeros
#pragma unroll
      for (int ii = 0; ii < kRegCols; ii += 4) {
        const int i = i_begin + ii < i_end ? i_begin + ii : 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dv = sm90::load4(x1 + r * x1p + i);
          acc[r] = fmaf(dv.x, wc_reg[ii], acc[r]);
          acc[r] = fmaf(dv.y, wc_reg[ii + 1], acc[r]);
          acc[r] = fmaf(dv.z, wc_reg[ii + 2], acc[r]);
          acc[r] = fmaf(dv.w, wc_reg[ii + 3], acc[r]);
        }
      }
    } else {
#pragma unroll 2
      for (int i = i_begin; i < i_end; i += 4) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w[q] = to_f(wc_r[(i + q) * kUnits + lane]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dv = sm90::load4(x1 + r * x1p + i);
          acc[r] = fmaf(dv.x, w[0], acc[r]);
          acc[r] = fmaf(dv.y, w[1], acc[r]);
          acc[r] = fmaf(dv.z, w[2], acc[r]);
          acc[r] = fmaf(dv.w, w[3], acc[r]);
        }
      }
    }
    if constexpr (!kMma) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        red[(warp * R + r) * kUnits + lane] = acc[r];
      }
    }
    __syncthreads();
    // (C2) the owners sum the partials in warp order (the next partials
    // are written after barrier B, which every owner reaches after this)
    if (owner) {
      float drh = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        drh += red[(w * R + warp) * kUnits + lane];
      }
      const float dzr = drh * hg * rg * (1.f - rg);
      dh_part += drh * rg;
      const T ru = from_f<T>(dzu), rr = from_f<T>(dzr);
      dproj[row * g3 + u] = ru;
      dproj[row * g3 + hidden + u] = rr;
      float* slot = x2 + warp * x2p + 2 * u;
      for (int i = 0; i < tiles; ++i) {
        const int rank = (static_cast<int>(blockIdx.x) + i) % tiles;
        sm90::store2(cluster.map_shared_rank(slot, rank), to_f(ru),
                     to_f(rr));
      }
    }
    // (B) every unit's [round(dzu), round(dzr)] has landed
    sm90::cluster_arrive();
    prefetch(t - kAhead, in);
    sm90::cluster_wait();
    // (D2) round([dzu, dzr]) . W_rz^T: this warp's units, R rows
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if constexpr (kMma) {
      // A[g][k] = round(dzu) (k even), round(dzr) (k odd) of row g, unit
      // k_begin + k / 2, as D1
      const int g = lane / 4;
      const float* arow = x2 + min(g, R - 1) * x2p + 2 * (lane % 4);
      float d[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kRegCols / 8; ++ks) {
        const int col = 2 * k_begin + ks * 16 < 2 * k_end
                            ? 2 * k_begin + ks * 16 : 0;
        const uint32_t a[4] = {
            g < R ? sm90::pack_bf16(sm90::load2(arow + col)) : 0u, 0u,
            g < R ? sm90::pack_bf16(sm90::load2(arow + col + 8)) : 0u, 0u};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          sm90::mma_bf16(d[nt], a, brz[ks][nt][0], brz[ks][nt][1]);
        }
      }
      sm90::store_d_rows(d, red + warp * R * kUnits, kUnits, R, lane);
    } else if constexpr (kRegW) {
      // two units a load (units past the warp's range: unit 0 and 1
      // against W registers of zeros)
#pragma unroll
      for (int kk = 0; kk < kRegCols; kk += 2) {
        const int k = k_begin + kk < k_end ? k_begin + kk : 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dv = sm90::load4(x2 + r * x2p + 2 * k);
          acc[r] = fmaf(dv.x, wrz_reg[kk][0], acc[r]);
          acc[r] = fmaf(dv.y, wrz_reg[kk][1], acc[r]);
          acc[r] = fmaf(dv.z, wrz_reg[kk + 1][0], acc[r]);
          acc[r] = fmaf(dv.w, wrz_reg[kk + 1][1], acc[r]);
        }
      }
    } else {
#pragma unroll 4
      for (int k = k_begin; k < k_end; ++k) {
        const float2 wv = sm90::load2(wrz_r + (k * kUnits + lane) * 2);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 dv = sm90::load2(x2 + r * x2p + 2 * k);
          acc[r] = fmaf(dv.x, wv.x, acc[r]);
          acc[r] = fmaf(dv.y, wv.y, acc[r]);
        }
      }
    }
    if constexpr (!kMma) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        red[(warp * R + r) * kUnits + lane] = acc[r];
      }
    }
    __syncthreads();
    if (owner) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += red[(w * R + warp) * kUnits + lane];
      }
      dh_c = dh_part + s;
    }
  };
  if constexpr (kAhead == 2) {
    for (int t = steps - 1; t >= 0; t -= 2) {
      step(t, in0);
      if (t > 0) step(t - 1, in1);
    }
  } else {
    for (int t = steps - 1; t >= 0; --t) step(t, in0);
  }

  if (owner) dh0[static_cast<size_t>(b) * hidden + u] = from_f<T>(dh_c);
  // no block leaves while a peer may still address its shared memory
  cluster.sync();
}

template <typename T, int R>
void* cl_kernel_w(int tiles) {
  return tiles <= sm90::kPortableClusterSize
             ? reinterpret_cast<void*>(gru_bwd_cluster<T, R, true>)
             : reinterpret_cast<void*>(gru_bwd_cluster<T, R, false>);
}

// rows per block: 1, 2, 4, 5 or 8; W in registers for clusters of at most
// 8 blocks
template <typename T>
void* cl_kernel(int rows, int tiles) {
  switch (rows) {
    case 1:
      return cl_kernel_w<T, 1>(tiles);
    case 2:
      return cl_kernel_w<T, 2>(tiles);
    case 4:
      return cl_kernel_w<T, 4>(tiles);
    case 5:
      return cl_kernel_w<T, 5>(tiles);
    default:
      return cl_kernel_w<T, 8>(tiles);
  }
}

// The cluster layout: the two recompute passes over the whole batch, then
// one launch of ceil(B / rows) clusters of ceil(H / 32) blocks. The rows
// per block come from the caller's planner; this checks that the layout
// takes the shape.
template <typename T>
int launch_cluster_layout(const void* proj, const void* mask,
                          const void* w_rz, const void* w_c,
                          const void* hprev, const void* dh_seq,
                          const void* dh_f, void* dproj, void* dh0, void* rh,
                          void* zbuf, int steps, int batch, int hidden,
                          int rows, cudaStream_t stream, int* info) {
  const int tiles = (hidden + kUnits - 1) / kUnits;
  if (hidden % 8 != 0 || tiles > kClMaxTiles ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 5 && rows != 8) ||
      zbuf == nullptr || rh == nullptr) {
    return kErrBadArgument;
  }
  const int batch_tiles = (batch + rows - 1) / rows;
  const int smem = cl_smem_bytes(hidden, rows, static_cast<int>(sizeof(T)));
  info[0] = tiles * batch_tiles;
  info[1] = rows;
  info[2] = 5;  // the W row slices resident, dz exchanged through DSMEM
  info[3] = smem;
  info[4] = batch;
  info[5] = 0;  // launches made
  const T* pj = static_cast<const T*>(proj);
  const T* hp = static_cast<const T*>(hprev);
  const T* wrz = static_cast<const T*>(w_rz);
  const T* wc = static_cast<const T*>(w_c);
  float* zb = static_cast<float*>(zbuf);
  T* rr = static_cast<T*>(rh);
  const int n = steps * batch;
  int rc = seqre::gemm(hp, wrz, n, hidden, 2 * hidden, 2 * hidden,
                       UrEpilogue<T>{pj, hp, zb, rr, hidden}, stream);
  if (rc != 0) return rc;
  rc = seqre::gemm(static_cast<const T*>(rr), wc, n, hidden, hidden, hidden,
                   CEpilogue<T>{pj, zb, hidden}, stream);
  if (rc != 0) return rc;
  const float* zc = zb;
  const float* m = static_cast<const float*>(mask);
  const T* dhs = static_cast<const T*>(dh_seq);
  const T* dhf = static_cast<const T*>(dh_f);
  T* dp = static_cast<T*>(dproj);
  T* dh = static_cast<T*>(dh0);
  void* args[] = {&zc, &m,  &wrz,   &wc,    &hp,    &dhs,
                  &dhf, &dp, &dh, &steps, &batch, &hidden};
  rc = sm90::launch_clusters(cl_kernel<T>(rows, tiles), tiles, batch_tiles,
                             kThreads, smem, stream, args);
  if (rc != 0) return rc;
  info[5] = 1;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (proj, w_rz, w_c, w_rz_t, w_c_t,
// hprev, dh_seq, dh_f, dproj, dh0, rh); mask and zbuf are float32.
// layout 0 = unit tiles: w_rz_t and w_c_t are w_rz and w_c transposed
//   ([2H, H] and [H, H], contiguous); rh is scratch of B*H elements; zbuf
//   and rows are not read (the grid and W placement are chosen here).
// layout 2 = clusters (H % 8 == 0, H <= 512) of ``rows`` (1, 2, 4, 5, 8)
//   batch rows per block: w_rz_t and w_c_t are not read; rh is scratch of
//   T*B*H elements, zbuf of T*B*3H.
// info receives {blocks of a full-chunk launch, batch rows per block, W
// placement (unit tiles: 2 all slices resident, 1 the column slices, 0
// none; clusters: 5, the row slices resident), dynamic shared memory
// bytes, batch rows per launch, launches made (the launches of the
// recurrence; the clusters' recompute passes are part of the call's
// first)}.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int gru_seq_bwd(int dtype, const void* proj, const void* mask,
                const void* w_rz, const void* w_c, const void* w_rz_t,
                const void* w_c_t, const void* hprev, const void* dh_seq,
                const void* dh_f, void* dproj, void* dh0, void* rh,
                void* zbuf, int steps, int batch, int hidden, int layout,
                int rows, int device, void* stream, int* info) {
  if (steps < 1 || batch < 1 || hidden < 1 || (dtype != 0 && dtype != 1) ||
      (layout != 0 && layout != 2)) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 2) {
    if (dtype == 0) {
      return launch_cluster_layout<float>(proj, mask, w_rz, w_c, hprev,
                                          dh_seq, dh_f, dproj, dh0, rh, zbuf,
                                          steps, batch, hidden, rows, s,
                                          info);
    }
    return launch_cluster_layout<__nv_bfloat16>(
        proj, mask, w_rz, w_c, hprev, dh_seq, dh_f, dproj, dh0, rh, zbuf,
        steps, batch, hidden, rows, s, info);
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  if (dtype == 0) {
    return launch<float>(dtype, proj, mask, w_rz, w_c, w_rz_t, w_c_t, hprev,
                         dh_seq, dh_f, dproj, dh0, rh, steps, batch, hidden,
                         device, s, info);
  }
  return launch<__nv_bfloat16>(dtype, proj, mask, w_rz, w_c, w_rz_t, w_c_t,
                               hprev, dh_seq, dh_f, dproj, dh0, rh, steps,
                               batch, hidden, device, s, info);
}

// The card's limits that ops/gru_kernels.gru_bwd_plan sizes its layouts
// by (sm90::card_limits: SM count, opt-in shared memory per block,
// clusters of 8 and of 16 of this file's cluster kernel held at once).
// Returns 0 or a cudaError_t value.
int gru_seq_bwd_limits(int device, int* out) {
  return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, device, out);
}

const char* gru_seq_bwd_error_string(int code) {
  switch (code) {
    case kErrNotCoResident:
      return "no co-resident grid: the batch and hidden size need more "
             "blocks than a cooperative launch can hold";
    case kErrNoCooperative:
      return "device does not support cooperative launches";
    case kErrBadArgument:
      return "bad argument (dtype or layout code, an empty shape, or a "
             "cluster layout the shape does not take)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
