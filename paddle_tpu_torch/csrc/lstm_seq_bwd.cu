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
// Three layouts, picked by the caller's planner (ops/lstm_kernels.bwd_plan)
// from the shapes and dtype and recorded in info[2]. In all three the T
// steps are serially dependent, and no float atomics are used: every sum
// runs in a fixed order, so a repeat is the same bit for bit. The caller
// sums dpeep_part over its rows.
//
// UNIT TILES (H % 8 != 0, or a width whose cluster does not fit). ONE
// cooperative launch per sequence (or row chunk) over a persistent grid.
// Block (unit tile, batch tile) owns 32 hidden units (one per lane) x R
// batch rows for the whole sequence; warp r keeps row r's dh/dc carries and
// dpeep partial sums of its 32 units in registers. Per step a block
//   (a) recomputes z for its 4 x 32 gate columns from hprev_t (staged in
//       shared memory; K = H split over the 8 warps against W's column
//       slice [H, 128], from shared memory when it fits, else from L2; the
//       partial sums reduced in a fixed order),
//   (b) runs the cell backward for its units and rows and writes dz to
//       dgates_t,
//   (c) waits at the grid barrier (dz of every gate column is needed next),
//   (d) forms the dh carry of its own units: dz_t rows of its batch tile
//       staged through shared memory (L2-only loads: other blocks wrote
//       them this step), K = 4H split over the warps against W's row slice
//       [32, 4H] (a column slice of W^T, which the caller passes too), from
//       shared memory when it fits.
// dpeep's per-row partials are reduced inside the block in row order and
// written to dpeep_part[first row of the tile, 3, H]. The host picks R and
// the W placement so that the grid is co-resident. Bound on this card: at
// small H by the step's serial latency (the hprev staging and K loop of
// (a), the grid barrier over every block, the dz round trip through L2: at
// H=256, B=64 8.5 us a step); at large H by the L2 traffic of the W slices
// (every batch tile reads both every step). That latency is what the
// cluster layout takes out; this layout stays for what it cannot take.
//
// CLUSTERS (K2: H % 8 == 0, H <= 32 x 16). The latency of unit tiles
// comes from a step's exchange of dz running through L2 behind a barrier
// over the whole grid, although batch rows never exchange anything: only
// the units of one row do. So each batch tile is ONE thread-block cluster
// of ceil(H / 32) blocks (8 at H=256; above 8 a non-portable size, up to
// 16), one per unit tile, and clusters never wait for each other (no
// cooperative launch: clusters that do not fit run later). Before the
// launch, the recompute pass (seq_recompute.cuh: bfloat16 on the tensor
// cores, float32 on the CUDA cores) writes z = gates + hprev . W for every
// step into the float32 workspace, so (a) leaves the step loop and W's
// column slice of (a) leaves shared memory. A block keeps
// W's columns of its own units [4 x 32 gate columns, all H units] for the
// sequence, in shared memory and, in clusters of at most 8 blocks, in
// registers (float32: a thread's 128 values; bfloat16: the B fragments of
// mma.sync.m16n8k16). Per step:
//   (C) the cell backward of its R rows x 32 units from z_t (the step's
//       inputs fetched one step ahead, two where (D) runs on the tensor
//       cores); dz to dgates_t and round(dz) (float32, so that (D) widens
//       nothing) to the block's own dz rows; a block barrier;
//   (D) from its own 128 columns, the partial dh of every unit for its R
//       rows, warp w taking units 32w .. 32w + 31 (and 32(w + 8) .. above
//       8 tiles): float32 FMA on the CUDA cores, or bfloat16 on the tensor
//       cores (products of bf16 values are exact in float32); the partials
//       of a group of 32 units stored into the shared memory of the block
//       that owns them (distributed shared memory: R x 32 values to each
//       peer, a quarter of what exchanging dz would move);
//   (B) one cluster barrier (arrive.release, the next inputs fetched,
//       wait.acquire); the dh carry of the block's units is the partials
//       of every block, summed in rank order.
// The received partials are double-buffered by step parity, so one
// cluster barrier a step is enough: a block stores into buffer t % 2 at
// step t - 2 only after the barrier of step t - 1, which every peer reaches
// after it has read that buffer at step t. A cluster barrier before the
// loop (peers' shared memory exists) and one before exit (no peer
// addresses a block that has left) frame it. R (rows per block: 1, 2, 4,
// 5 or 8) is the smallest that keeps the batch's clusters co-resident,
// from the card's count of active clusters (lstm_seq_bwd_limits: 15 of 8
// on an H100 SXM, so B=64 runs as 13 clusters of 5 rows). Bound on this
// card: the step is still serial, now on the latency of the cell, two
// barriers (one of the block, one of the cluster over 8 SMs instead of a
// grid barrier over 128) and the partials' round trip between SMs, plus
// R x 128 x H FMAs per block in float32; the recompute is one GEMM at the
// arithmetic rate.
//
// W TILES (large H: K4 at H=1280). W [H, 4H] is cut into a 2-D grid of
// tiles, unit range x gate-column range (at H=1280: 8 x 16 tiles of 160
// units x 320 columns, 128 blocks), and block (unit tile, column tile) owns
// one tile for the whole sequence and serves ALL rows of the launch with
// it, so each byte of W is read once per step, by one block, from shared
// memory (bfloat16: the tile stays resident, 128 KB at H=1280) or streamed
// once per step from L2 through a 3-stage cp.async ring (float32: the 26 MB
// of W and the staging every block needs exceed the card's shared memory,
// but fit its 50 MB L2). The recompute pass runs first, as for clusters.
// ONE cooperative launch per chunk of rows; per step:
//   (C) the cell backward, one (row, unit) pair per thread slot of the
//       whole grid (carries and dpeep sums in registers); its dh carry is
//       dh_pass plus the column tiles' partials of the step before, summed
//       in tile order; grid barrier;
//   (D) each block stages dz_t's rows of its columns (L2-only loads) and
//       forms the partial dh[b, u] = sum over its columns of dz[b, j]
//       W[u, j] for every row b and unit u of its tile, written to the
//       float32 workspace part[column tile, b, u] (float32, and bfloat16
//       launches of at most 8 rows: f32 FMA on the CUDA cores, a warp takes
//       1 or 8 rows, a lane units lane + 32j for a compile-time count of j;
//       bfloat16 launches of 9-64 rows: mma.sync.m16n8k16 on the tensor
//       cores, a warp one m16 tile of rows x half the tile's units); the
//       next step's inputs of the cell are fetched; grid barrier.
// Two grid barriers per step; dpeep is written per (row, unit) to
// dpeep_part[b, 3, H]. A batch above 64 rows or 4 pairs per thread slot
// runs as equal row chunks, one launch each, in stream order. Bound on this
// card: a step's work is spread over 128 SMs: B*H*4H f32 FMAs of (D) (13.6
// us per step at the CUDA cores' peak at B=64, H=1280; in bfloat16 on the
// tensor cores about a microsecond) plus two grid barriers and the gather
// of the column tiles' partials.

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

// ---------------------------------------------------------------------------
// The recompute pass of the cluster and W-tile layouts: z = gates + hprev . W
// in float32 for every step ([rows, H] x [H, 4H], rows = T * B), before the
// recurrence's launch (seq_recompute.cuh: tensor cores for bfloat16, CUDA
// cores for float32).

template <typename T>
struct ZEpilogue {  // z = gates + hprev . W
  const T* gates;
  float* z;
  int g4;
  template <int kN>
  __device__ __forceinline__ void operator()(long long row, int col,
                                             const float (&v)[kN]) const {
    const size_t o = static_cast<size_t>(row) * g4 + col;
    if constexpr (kN == 4) {
      // gemm (float32 only): one 16-byte load and store (col % 4 == 0)
      const float4 gv = __ldg(reinterpret_cast<const float4*>(gates + o));
      *reinterpret_cast<float4*>(z + o) =
          make_float4(gv.x + v[0], gv.y + v[1], gv.z + v[2], gv.w + v[3]);
    } else {
      // gemm in bfloat16: one load of the gate pair and one 8-byte store
      // (col % 2 == 0)
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gates + o));
      *reinterpret_cast<float2*>(z + o) =
          make_float2(gv.x + v[0], gv.y + v[1]);
    }
  }
};

// ``tag`` only selects the dtype.
template <typename T>
int recompute_z(const void* gates, const void* hprev, const void* w_rec,
                void* zbuf, int rows, int hidden, cudaStream_t stream,
                const T* /*tag*/) {
  const int g4 = 4 * hidden;
  const T* a = static_cast<const T*>(hprev);
  const T* b = static_cast<const T*>(w_rec);
  const ZEpilogue<T> epi{static_cast<const T*>(gates),
                         static_cast<float*>(zbuf), g4};
  return seqre::gemm(a, b, rows, hidden, g4, g4, epi, stream);
}

// ---------------------------------------------------------------------------
// Clusters: one thread-block cluster per batch tile.

// The layout's constants and cl_smem_bytes have a copy in the caller's
// planner (ops/lstm_kernels.py, _CL_*), which a CPU test holds equal to
// these.
constexpr int kClMaxTiles = 16;  // unit tiles (blocks) per cluster, at most
// the local dz rows are padded by 8 floats (32 bytes), so that the
// tensor-core path's fragment loads of 8 rows hit distinct banks
constexpr int kDzLd = kCols + 8;

// Shared memory of a cluster block in bytes: W's column slice [128][32 x
// tiles] in the gates' dtype, then the block's dz rows [R][kDzLd] (round(dz)
// held in float32, so that (D) widens nothing) and the partial sums it
// receives [2][tiles][R][32], in float32.
__host__ __device__ constexpr int cl_smem_bytes(int hidden, int rows,
                                                int elem_bytes) {
  return round_up(kCols * round_up(hidden, kUnits) * elem_bytes, 16) +
         rows * kDzLd * static_cast<int>(sizeof(float)) +
         2 * round_up(hidden, kUnits) * rows *
             static_cast<int>(sizeof(float));
}

// kRegW (clusters of at most 8 blocks, H <= 256: one group of 32 units per
// warp in (D)): each thread keeps W in registers for the sequence, so that
// (D) reads only dz from shared memory: in float32 the 128 W values of its
// unit; in bfloat16 the B fragments of mma.sync.m16n8k16, (D) then on the
// tensor cores (products of bf16 values are exact in float32, so this sums
// what the float32 loop sums, in another order). Else (D) reads W's column
// slice from shared memory.
template <typename T, int R, bool kRegW>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_cluster(const float* __restrict__ z, const float* __restrict__ mask,
                 const T* __restrict__ w_rec, const float* __restrict__ peep,
                 const T* __restrict__ cprev, const T* __restrict__ c_seq,
                 const T* __restrict__ dh_seq, const T* __restrict__ dh_f,
                 const T* __restrict__ dc_f, T* __restrict__ dgates,
                 T* __restrict__ dh0, T* __restrict__ dc0,
                 float* __restrict__ dpeep_part, int steps, int batch,
                 int hidden) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kEsz = static_cast<int>(sizeof(T));
  constexpr bool kMma = kRegW && std::is_same<T, __nv_bfloat16>::value;
  const int g4 = 4 * hidden;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = gridDim.x;  // the cluster: one block per unit tile
  const int hp = tiles * kUnits;  // the units, padded to whole tiles
  const int src = blockIdx.x;     // this block's rank in the cluster
  const int u0 = src * kUnits;
  const int u = u0 + lane;
  const bool u_ok = u < hidden;
  const int b0 = blockIdx.y * R;
  const int b = b0 + warp;  // warp r owns row r of the tile
  const bool owner = warp < R && u_ok && b < batch;

  // shared memory: wc[j * hp + v] = W[v, (j % 4) * H + u0 + j / 4], W's
  // columns of this block's units (local column j: unit u0 + j / 4, gate
  // j % 4) for every unit v; dzl[r * kDzLd + j] = round(dz) of row r,
  // local column j; rcv[2][tiles][R][32]: the partial sums over each
  // block's columns for this block's units, by step parity
  T* wc = reinterpret_cast<T*>(smem_raw);
  float* dzl = reinterpret_cast<float*>(
      smem_raw + round_up(kCols * hp * kEsz, 16));
  float* rcv = dzl + R * kDzLd;
  for (int e = threadIdx.x; e < kCols * hp; e += kThreads) {
    const int v = e / kCols;  // consecutive threads read one row of W
    const int j = e - v * kCols;
    const int uu = u0 + j / 4;
    wc[j * hp + v] =
        v < hidden && uu < hidden
            ? w_rec[static_cast<size_t>(v) * g4 + (j % 4) * hidden + uu]
            : from_f<T>(0.f);
  }
  // rows past the batch are never stored: zeros, read and discarded
  for (int e = threadIdx.x; e < R * kDzLd + 2 * hp * R; e += kThreads) {
    dzl[e] = 0.f;
  }
  __syncthreads();  // W's slice is complete
  // W in registers, this warp's group of 32 units (warp < tiles): float32
  // W[warp * 32 + lane, column of j]; or the B fragments of B[k][n] =
  // W[warp * 32 + nt * 8 + n, column of 16 ks + k], lane (g, t) holding
  // B[2t, 2t + 1][g] and B[2t + 8, 2t + 9][g] (sm90_mma.cuh)
  float wreg[kRegW && !kMma ? kCols : 1];
  uint32_t bfrag[kMma ? kCols / 16 : 1][4][2];
  if constexpr (kMma) {
#pragma unroll
    for (int ks = 0; ks < kCols / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = ks * 16 + 2 * (lane % 4) + 8 * h;
          const int v = warp * kUnits + nt * 8 + lane / 4;
          __nv_bfloat162 p;
          p.x = warp < tiles ? wc[j * hp + v] : from_f<T>(0.f);
          p.y = warp < tiles ? wc[(j + 1) * hp + v] : from_f<T>(0.f);
          bfrag[ks][nt][h] = *reinterpret_cast<const uint32_t*>(&p);
        }
  } else if constexpr (kRegW) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      wreg[j] = warp < tiles ? to_f(wc[j * hp + warp * kUnits + lane]) : 0.f;
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
  // the cell's inputs of a step, fetched kAhead steps ahead: two where (D)
  // runs on the tensor cores (so short that a load fetched one step ahead
  // has not landed), into one of two register sets (the loop is unrolled
  // by two, so that no copy waits on a load in flight); one where the
  // CUDA-core loop hides the loads (and unrolling costs more than it
  // saves: measured on the card)
  constexpr int kAhead = kMma ? 2 : 1;
  struct StepIn {
    float z[4];
    float cp, cs, dhs;
    bool live;
  };
  StepIn in0 = {}, in1 = {};
  auto prefetch = [&](int t, StepIn& in) {
    if (!owner || t < 0) return;
    const size_t r = static_cast<size_t>(t) * batch + b;
    const float* zr = z + r * g4 + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) in.z[q] = __ldg(zr + q * hidden);
    const size_t o = r * hidden + u;
    in.cp = load_ro(cprev + o);
    in.cs = load_ro(c_seq + o);
    in.dhs = load_ro(dh_seq + o);
    in.live = mask[r] > 0.f;
  };
  prefetch(steps - 1, in0);
  if (kAhead == 2) prefetch(steps - 2, in1);
  // every peer's shared memory exists, and this block's W slice and zeroed
  // buffers are complete, before anyone stores into a peer
  cluster.sync();

  auto step = [&](int t, StepIn& in) {
    float* rt = rcv + (t & 1) * hp * R;  // this step's received partials
    // (C) the cell backward; round(dz) to this block's dz rows
    if (owner) {
      const float cp = in.cp;
      const bool live = in.live;
      const float ig = sigmoidf(in.z[0] + cp * pi);
      const float fg = sigmoidf(in.z[1] + cp * pf);
      const float gg = tanhf(in.z[2]);
      const float cn = fg * cp + ig * gg;
      const float og = sigmoidf(in.z[3] + cn * po);
      const float tc = tanhf(in.cs);
      const float dh_tot = in.dhs + dh_c;
      const float dh_eff = live ? dh_tot : 0.f;
      const float dzo = dh_eff * tc * og * (1.f - og);
      const float dc_eff = (live ? dc_c : 0.f) +
                           dh_eff * og * (1.f - tc * tc) + dzo * po;
      const float dzi = dc_eff * gg * ig * (1.f - ig);
      const float dzf = dc_eff * cp * fg * (1.f - fg);
      const float dzg = dc_eff * ig * (1.f - gg * gg);
      const T ri = from_f<T>(dzi), rf = from_f<T>(dzf);
      const T rg = from_f<T>(dzg), ro = from_f<T>(dzo);
      T* dg = dgates + (static_cast<size_t>(t) * batch + b) * g4 + u;
      dg[0] = ri;
      dg[hidden] = rf;
      dg[2 * hidden] = rg;
      dg[3 * hidden] = ro;
      dh_pass = live ? 0.f : dh_tot;
      dc_c = dc_eff * fg + dzi * pi + dzf * pf + (live ? 0.f : dc_c);
      dp0 += dzi * cp;
      dp1 += dzf * cp;
      dp2 += dzo * cn;
      sm90::store4(dzl + warp * kDzLd + lane * 4, to_f(ri), to_f(rf),
                   to_f(rg), to_f(ro));
    }
    __syncthreads();  // this block's dz rows are complete
    // (D) for each group of 32 units (one per warp, two per warp above 8
    // tiles), the partial sums over this block's columns for the R rows,
    // stored into the group's block at rcv[src]
    for (int grp = warp; grp < tiles; grp += kWarps) {
      float* dst = cluster.map_shared_rank(rt, grp) + src * R * kUnits;
      if constexpr (kMma) {
        const int g = lane / 4;
        const float* arow = dzl + min(g, R - 1) * kDzLd + 2 * (lane % 4);
        float d[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kCols / 16; ++ks) {
          // rows past R and rows 8-15 of A are zero
          const uint32_t a[4] = {
              g < R ? sm90::pack_bf16(sm90::load2(arow + ks * 16)) : 0u, 0u,
              g < R ? sm90::pack_bf16(sm90::load2(arow + ks * 16 + 8)) : 0u,
              0u};
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            sm90::mma_bf16(d[nt], a, bfrag[ks][nt][0], bfrag[ks][nt][1]);
          }
        }
        sm90::store_d_rows(d, dst, kUnits, R, lane);
      } else {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        if constexpr (kRegW) {
#pragma unroll
          for (int l = 0; l < kUnits; ++l) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 dv = sm90::load4(dzl + r * kDzLd + 4 * l);
              acc[r] = fmaf(dv.x, wreg[4 * l], acc[r]);
              acc[r] = fmaf(dv.y, wreg[4 * l + 1], acc[r]);
              acc[r] = fmaf(dv.z, wreg[4 * l + 2], acc[r]);
              acc[r] = fmaf(dv.w, wreg[4 * l + 3], acc[r]);
            }
          }
        } else {
          const T* wv = wc + grp * kUnits + lane;
#pragma unroll 4
          for (int l = 0; l < kUnits; ++l) {
            const float w0 = to_f(wv[(4 * l) * hp]);
            const float w1 = to_f(wv[(4 * l + 1) * hp]);
            const float w2 = to_f(wv[(4 * l + 2) * hp]);
            const float w3 = to_f(wv[(4 * l + 3) * hp]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 dv = sm90::load4(dzl + r * kDzLd + 4 * l);
              acc[r] = fmaf(dv.x, w0, acc[r]);
              acc[r] = fmaf(dv.y, w1, acc[r]);
              acc[r] = fmaf(dv.z, w2, acc[r]);
              acc[r] = fmaf(dv.w, w3, acc[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r * kUnits + lane] = acc[r];
      }
    }
    // (B) every block's partials for this block's units have landed; a
    // block stores into rcv of parity t % 2 again at step t - 2, after the
    // barrier of step t - 1, which every owner here reaches after reading
    sm90::cluster_arrive();
    prefetch(t - kAhead, in);
    sm90::cluster_wait();
    // the dh carry: the blocks' partial sums in rank order
    if (owner) {
      float s = 0.f;
      for (int k = 0; k < tiles; ++k) s += rt[(k * R + warp) * kUnits + lane];
      dh_c = dh_pass + s;
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

  if (owner) {
    const size_t o = static_cast<size_t>(b) * hidden + u;
    dh0[o] = from_f<T>(dh_c);
    dc0[o] = from_f<T>(dc_c);
  }
  // dpeep: this tile's rows summed in row order (dzl is free: every (D)
  // of the last step ended before its barrier)
  float* red = dzl;
  if (warp < R) {
    red[(0 * R + warp) * kUnits + lane] = owner ? dp0 : 0.f;
    red[(1 * R + warp) * kUnits + lane] = owner ? dp1 : 0.f;
    red[(2 * R + warp) * kUnits + lane] = owner ? dp2 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 3 * kUnits) {
    const int q = threadIdx.x / kUnits;
    if (u_ok) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s += red[(q * R + r) * kUnits + lane];
      dpeep_part[(static_cast<size_t>(b0) * 3 + q) * hidden + u] = s;
    }
  }
  // no block leaves while a peer may still address its shared memory
  cluster.sync();
}

template <typename T, int R>
void* cl_kernel_w(int tiles) {
  return tiles <= sm90::kPortableClusterSize
             ? reinterpret_cast<void*>(lstm_bwd_cluster<T, R, true>)
             : reinterpret_cast<void*>(lstm_bwd_cluster<T, R, false>);
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

// The cluster layout: the recompute pass over the whole batch, then one
// launch of ceil(B / rows) clusters of ceil(H / 32) blocks. The rows per
// block come from the caller's planner; this checks that the layout takes
// the shape.
template <typename T>
int launch_cluster_layout(const void* gates, const void* mask,
                          const void* w_rec, const void* peep,
                          const void* hprev, const void* cprev,
                          const void* c_seq, const void* dh_seq,
                          const void* dh_f, const void* dc_f, void* dgates,
                          void* dh0, void* dc0, void* dpeep_part, void* zbuf,
                          int steps, int batch, int hidden, int rows,
                          cudaStream_t stream, int* info) {
  const int tiles = (hidden + kUnits - 1) / kUnits;
  if (hidden % 8 != 0 || tiles > kClMaxTiles ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 5 && rows != 8) ||
      zbuf == nullptr) {
    return kErrBadArgument;
  }
  const int batch_tiles = (batch + rows - 1) / rows;
  const int smem = cl_smem_bytes(hidden, rows, static_cast<int>(sizeof(T)));
  info[0] = tiles * batch_tiles;
  info[1] = rows;
  info[2] = 5;  // W's row slice resident, dz exchanged through DSMEM
  info[3] = smem;
  info[4] = batch;
  info[5] = 0;  // launches made
  int rc = recompute_z(gates, hprev, w_rec, zbuf, steps * batch, hidden,
                       stream, static_cast<const T*>(nullptr));
  if (rc != 0) return rc;
  const float* zb = static_cast<const float*>(zbuf);
  const float* m = static_cast<const float*>(mask);
  const T* w = static_cast<const T*>(w_rec);
  const float* p = static_cast<const float*>(peep);
  const T* cp = static_cast<const T*>(cprev);
  const T* cs = static_cast<const T*>(c_seq);
  const T* dhs = static_cast<const T*>(dh_seq);
  const T* dhf = static_cast<const T*>(dh_f);
  const T* dcf = static_cast<const T*>(dc_f);
  T* dg = static_cast<T*>(dgates);
  T* dh = static_cast<T*>(dh0);
  T* dc = static_cast<T*>(dc0);
  float* dpp = static_cast<float*>(dpeep_part);
  void* args[] = {&zb, &m,  &w,  &p,   &cp,    &cs,    &dhs,   &dhf,
                  &dcf, &dg, &dh, &dc, &dpp, &steps, &batch, &hidden};
  rc = sm90::launch_clusters(cl_kernel<T>(rows, tiles), tiles, batch_tiles,
                             kThreads, smem, stream, args);
  if (rc != 0) return rc;
  info[5] = 1;
  return 0;
}

// ---------------------------------------------------------------------------
// W tiles: the recurrence.

// The layout's constants and wt_smem_bytes have a copy in the caller's
// planner (ops/lstm_kernels.py, _BWD_*), which a CPU test holds equal to
// these.
constexpr int kWtPairs = 4;   // (row, unit) pairs per thread slot, at most
constexpr int kWtChunk = 32;  // W columns per chunk
constexpr int kWtStages = 3;

// elements of a 16-byte copy, and the W row pitch of a chunk in elements:
// 144 bytes (float32) or 80 bytes (bfloat16), 16-byte aligned and free of
// bank conflicts for a warp's 16-byte loads of 32 consecutive rows
template <typename T>
__host__ __device__ constexpr int wt_vec() {
  return 16 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int wt_ld() {
  return kWtChunk + wt_vec<T>();
}

// dz rows are staged in the gates' dtype at a pitch of cols + 16/esz
// elements (16-byte aligned rows for cp.async)
template <typename T>
__host__ __device__ constexpr int wt_stage_pitch(int cols) {
  return cols + wt_vec<T>();
}

template <typename T>
int wt_smem_bytes(int units, int cols, int rows_per_warp, bool resident) {
  const int chunks = cols / kWtChunk;
  return static_cast<int>(sizeof(T)) *
         ((resident ? chunks : kWtStages) * units * wt_ld<T>() +
          kWarps * rows_per_warp * wt_stage_pitch<T>(cols));
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 4 consecutive staged dz values (a broadcast: every lane of a warp reads
// the same row)
__device__ __forceinline__ float4 load4_smem(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_smem(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// (D), one block's partial dh[b, u] = sum over its columns j of
// dz[b, j] W[u, j], 32 columns (one chunk) at a time: ``wc`` is the chunk's
// W rows (the tile's units, pitch wt_ld), ``st`` the staged dz rows (pitch
// ``sp``), ``col`` the chunk's first column in the staging. ``store``
// writes the block's partials to its column tile's slice of ``part``.
//
// DhSimt: f32 FMA on the CUDA cores; warp w takes rows wR .. wR + R - 1, a
// lane units lane + 32 j (j < UJ).
template <typename T, int R, int UJ>
struct DhSimt {
  float acc[R][UJ];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < UJ; ++j) acc[r][j] = 0.f;
  }

  __device__ __forceinline__ void chunk(const T* wc, const T* st, int sp,
                                        int col, int warp, int lane) {
    constexpr int kVec = wt_vec<T>();
    constexpr int kLd = wt_ld<T>();
    const T* dz = st + warp * R * sp + col;
#pragma unroll
    for (int jj = 0; jj < kWtChunk; jj += kVec) {
      float wv[UJ][kVec];
#pragma unroll
      for (int j = 0; j < UJ; ++j) {
        load_vec(wc + (lane + 32 * j) * kLd + jj, wv[j]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int v = 0; v < kVec; v += 4) {
          const float4 d = load4_smem(dz + r * sp + jj + v);
#pragma unroll
          for (int j = 0; j < UJ; ++j) {
            acc[r][j] = fmaf(d.x, wv[j][v], acc[r][j]);
            acc[r][j] = fmaf(d.y, wv[j][v + 1], acc[r][j]);
            acc[r][j] = fmaf(d.z, wv[j][v + 2], acc[r][j]);
            acc[r][j] = fmaf(d.w, wv[j][v + 3], acc[r][j]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* pt, int batch, int hidden,
                                        int u_base, int warp, int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = warp * R + r;
#pragma unroll
      for (int j = 0; j < UJ; ++j) {
        const int u = u_base + lane + 32 * j;
        if (b < batch && u < hidden) {
          pt[static_cast<size_t>(b) * hidden + u] = acc[r][j];
        }
      }
    }
  }
};

// DhMma: bfloat16 on the tensor cores, mma.sync.m16n8k16 with float32
// accumulators (products of bf16 values are exact in float32), for 64
// staged rows: warp w takes rows 16 (w % 4) .. + 15 (one m16 tile of dz)
// and half w / 4 of the tile's units (2 UJ n8 tiles). A is dz (row major,
// ldmatrix); B is W[u, j] with the reduction index j contiguous, which is
// the "col" operand as it lies (ldmatrix without .trans). The rows' pitches
// (80 bytes for W, 2 cols + 16 for dz) keep ldmatrix free of bank conflicts.
template <int UJ>
struct DhMma {
  float acc[2 * UJ][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 2 * UJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  __device__ __forceinline__ void chunk(const __nv_bfloat16* wc,
                                        const __nv_bfloat16* st, int sp,
                                        int col, int warp, int lane) {
    constexpr int kLd = wt_ld<__nv_bfloat16>();
    const int wm = (warp % 4) * 16;
    const int wn = (warp / 4) * 16 * UJ;
    const int m = lane / 8;  // the 8 x 8 matrix this lane addresses
#pragma unroll
    for (int ks = 0; ks < kWtChunk; ks += 16) {
      uint32_t a[4];
      sm90::ldmatrix_x4(a, st + (wm + lane % 16) * sp + col + ks +
                               (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < UJ; ++np) {
        // n8 tiles 2np and 2np + 1, k 0-7 and 8-15 of each
        uint32_t b[4];
        sm90::ldmatrix_x4(b, wc + (wn + np * 16 + (m / 2) * 8 + lane % 8) *
                                      kLd +
                                  ks + (m % 2) * 8);
        sm90::mma_bf16(acc[2 * np], a, b[0], b[1]);
        sm90::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* pt, int batch, int hidden,
                                        int u_base, int warp, int lane) {
    const int g = lane / 4;
    const int t = lane % 4;
    const int wm = (warp % 4) * 16;
    const int wn = (warp / 4) * 16 * UJ;
#pragma unroll
    for (int n = 0; n < 2 * UJ; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = wm + g + 8 * h;
        const int u = u_base + wn + n * 8 + 2 * t;  // H % 8 == 0: u+1 too
        if (b < batch && u < hidden) {
          *reinterpret_cast<float2*>(pt + static_cast<size_t>(b) * hidden +
                                     u) =
              make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
        }
      }
  }
};

// R: batch rows per warp (8R rows per launch at most); UJ: units per lane
// (32 UJ units per tile; a compile-time count, so that no multiply-add is
// issued for a unit a lane does not hold); kResident: the W tile stays in
// shared memory for the sequence, else it streams from L2 once per step
// through a 3-stage ring.
template <typename T, int R, int UJ, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_wtiles(const float* __restrict__ z, const float* __restrict__ mask,
                const T* __restrict__ w_rec, const float* __restrict__ peep,
                const T* __restrict__ cprev, const T* __restrict__ c_seq,
                const T* __restrict__ dh_seq, const T* __restrict__ dh_f,
                const T* __restrict__ dc_f, T* dgates, T* __restrict__ dh0,
                T* __restrict__ dc0, float* __restrict__ dpeep_part,
                float* part, int steps, int batch, int stride, int hidden,
                int units, int cols, int unit_tiles, int row_base) {
  // batch: the rows of this launch; stride: the rows of the whole batch,
  // the pitch of every [T, B, ...] array (the pointers start at this
  // launch's first row, which is row ``row_base`` of the whole batch)
  constexpr int kVec = wt_vec<T>();
  constexpr int kLd = wt_ld<T>();
  // (D) on the tensor cores in bfloat16 at 8 rows per warp, else on the
  // CUDA cores
  using Dh = typename std::conditional<
      std::is_same<T, __nv_bfloat16>::value && R == 8, DhMma<UJ>,
      DhSimt<T, R, UJ>>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int g4 = 4 * hidden;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int iu = blockIdx.x % unit_tiles;
  const int ic = blockIdx.x / unit_tiles;
  const int col_tiles = gridDim.x / unit_tiles;
  const int u_base = iu * units;
  const int c_base = ic * cols;
  const int chunks = cols / kWtChunk;
  const int sp = wt_stage_pitch<T>(cols);
  T* w_s = reinterpret_cast<T*>(smem_raw);
  T* st = w_s + static_cast<size_t>(kResident ? chunks : kWtStages) * units *
                    kLd;

  // chunk c of this block's W tile into slot ``slot``: rows u_base ..
  // u_base + units - 1, columns c_base + 32 c .. (zeros past H and 4H)
  auto load_w = [&](int c, int slot) {
    constexpr int kSegs = kWtChunk / kVec;
    const int col = c_base + c * kWtChunk;
    for (int e = tid; e < units * kSegs; e += kThreads) {
      const int r = e / kSegs;
      const int sg = (e % kSegs) * kVec;
      const bool ok = u_base + r < hidden && col + sg < g4;
      sm90::cp_async16(
          w_s + (static_cast<size_t>(slot) * units + r) * kLd + sg,
          ok ? w_rec + static_cast<size_t>(u_base + r) * g4 + col + sg
             : w_rec,
          ok ? 16 : 0);
    }
    sm90::cp_async_commit();
  };
  if (kResident) {
    for (int c = 0; c < chunks; ++c) load_w(c, c);
    sm90::cp_async_wait<0>();
    __syncthreads();
  }

  // this thread slot's (row, unit) pairs of the cell backward
  const int slots = gridDim.x * kThreads;
  const int slot = blockIdx.x * kThreads + tid;
  int pb[kWtPairs], pu[kWtPairs];
  bool pok[kWtPairs];
  float pi[kWtPairs], pf[kWtPairs], po[kWtPairs];
  float dh_c[kWtPairs], dh_pass[kWtPairs], dc_c[kWtPairs];
  float dp0[kWtPairs], dp1[kWtPairs], dp2[kWtPairs];
  // the pairs' inputs of the next step, fetched ahead (before the barrier
  // that precedes their use, so that their latency hides behind it)
  float nz[kWtPairs][4], ncp[kWtPairs], ncs[kWtPairs], ndhs[kWtPairs];
  bool nlive[kWtPairs];
  auto prefetch = [&](int t) {
    const size_t row_t = static_cast<size_t>(t) * stride;
#pragma unroll
    for (int i = 0; i < kWtPairs; ++i) {
      if (!pok[i]) continue;
      const size_t r = row_t + pb[i];
      const float* zr = z + r * g4 + pu[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) nz[i][q] = __ldg(zr + q * hidden);
      const size_t o = r * hidden + pu[i];
      ncp[i] = load_ro(cprev + o);
      ncs[i] = load_ro(c_seq + o);
      ndhs[i] = load_ro(dh_seq + o);
      nlive[i] = mask[r] > 0.f;
    }
  };
#pragma unroll
  for (int i = 0; i < kWtPairs; ++i) {
    const long long p = slot + static_cast<long long>(i) * slots;
    pok[i] = p < static_cast<long long>(batch) * hidden;
    pb[i] = pok[i] ? static_cast<int>(p / hidden) : 0;
    pu[i] = pok[i] ? static_cast<int>(p % hidden) : 0;
    pi[i] = pf[i] = po[i] = 0.f;
    dh_c[i] = dh_pass[i] = dc_c[i] = 0.f;
    dp0[i] = dp1[i] = dp2[i] = 0.f;
    if (pok[i]) {
      pi[i] = peep[pu[i]];
      pf[i] = peep[hidden + pu[i]];
      po[i] = peep[2 * hidden + pu[i]];
      const size_t o = static_cast<size_t>(pb[i]) * hidden + pu[i];
      dh_c[i] = to_f(dh_f[o]);
      dc_c[i] = to_f(dc_f[o]);
    }
  }
  // the dh carries: dh_pass plus the column tiles' partials of the step
  // just done, summed in tile order (the loads of all pairs and of 4 tiles
  // at a time are in flight together)
  auto gather = [&]() {
    float s[kWtPairs];
#pragma unroll
    for (int i = 0; i < kWtPairs; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int q = 0; q < col_tiles; ++q) {
#pragma unroll
      for (int i = 0; i < kWtPairs; ++i) {
        if (pok[i]) {
          s[i] += __ldcg(part + (static_cast<size_t>(q) * batch + pb[i]) *
                                    hidden + pu[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kWtPairs; ++i) dh_c[i] = dh_pass[i] + s[i];
  };

  prefetch(steps - 1);
  for (int t = steps - 1; t >= 0; --t) {
    const size_t row_t = static_cast<size_t>(t) * stride;
    // (C) the cell backward of this slot's pairs
    if (t < steps - 1) gather();
#pragma unroll
    for (int i = 0; i < kWtPairs; ++i) {
      if (!pok[i]) continue;
      const float cp = ncp[i];
      const bool live = nlive[i];
      const float ig = sigmoidf(nz[i][0] + cp * pi[i]);
      const float fg = sigmoidf(nz[i][1] + cp * pf[i]);
      const float gg = tanhf(nz[i][2]);
      const float cn = fg * cp + ig * gg;
      const float og = sigmoidf(nz[i][3] + cn * po[i]);
      const float tc = tanhf(ncs[i]);
      const float dh_tot = ndhs[i] + dh_c[i];
      const float dh_eff = live ? dh_tot : 0.f;
      const float dzo = dh_eff * tc * og * (1.f - og);
      const float dc_eff = (live ? dc_c[i] : 0.f) +
                           dh_eff * og * (1.f - tc * tc) + dzo * po[i];
      const float dzi = dc_eff * gg * ig * (1.f - ig);
      const float dzf = dc_eff * cp * fg * (1.f - fg);
      const float dzg = dc_eff * ig * (1.f - gg * gg);
      T* dg = dgates + (row_t + pb[i]) * g4 + pu[i];
      dg[0] = from_f<T>(dzi);
      dg[hidden] = from_f<T>(dzf);
      dg[2 * hidden] = from_f<T>(dzg);
      dg[3 * hidden] = from_f<T>(dzo);
      dh_pass[i] = live ? 0.f : dh_tot;
      dc_c[i] = dc_eff * fg + dzi * pi[i] + dzf * pf[i] +
                (live ? 0.f : dc_c[i]);
      dp0[i] += dzi * cp;
      dp1[i] += dzf * cp;
      dp2[i] += dzo * cn;
    }
    grid.sync();  // dz_t of every gate column complete everywhere

    // (D) this tile's partial dh: dz_t's rows of the tile's columns staged
    // by cp.async (an L2 read: other blocks wrote them this step; zeros past
    // the launch's rows), then W chunks 0 and 1 in flight (ring)
    {
      constexpr int kSegs = 16 / static_cast<int>(sizeof(T));
      const int segs = cols / kSegs;
      for (int e = tid; e < kWarps * R * segs; e += kThreads) {
        const int b = e / segs;
        const int j = (e % segs) * kSegs;
        const bool ok = b < batch && c_base + j < g4;
        sm90::cp_async16(st + b * sp + j,
                         ok ? dgates + (row_t + b) * g4 + c_base + j
                            : dgates,
                         ok ? 16 : 0);
      }
      sm90::cp_async_commit();
    }
    if (!kResident) {
      load_w(0, 0);
      if (chunks > 1) load_w(1, 1);
    } else {
      sm90::cp_async_wait<0>();
    }
    Dh dh;
    dh.zero();
    if (kResident) __syncthreads();  // the staged rows are visible
    for (int c = 0; c < chunks; ++c) {
      if (!kResident) {
        // chunk c (and, the first time, the staged rows) has landed; the
        // slot of chunk c - 1 is free
        if (c + 1 < chunks) {
          sm90::cp_async_wait<1>();
        } else {
          sm90::cp_async_wait<0>();
        }
        __syncthreads();
        if (c + 2 < chunks) load_w(c + 2, (c + 2) % kWtStages);
      }
      dh.chunk(w_s + static_cast<size_t>(kResident ? c : c % kWtStages) *
                         units * kLd,
               st, sp, c * kWtChunk, warp, lane);
    }
    dh.store(part + static_cast<size_t>(ic) * batch * hidden, batch, hidden,
             u_base, warp, lane);
    if (t > 0) prefetch(t - 1);
    __syncthreads();  // the staging and the ring are free for the next step
    grid.sync();      // every tile's partials complete
  }

  gather();
#pragma unroll
  for (int i = 0; i < kWtPairs; ++i) {
    if (!pok[i]) continue;
    const size_t o = static_cast<size_t>(pb[i]) * hidden + pu[i];
    dh0[o] = from_f<T>(dh_c[i]);
    dc0[o] = from_f<T>(dc_c[i]);
    float* dp =
        dpeep_part + static_cast<size_t>(row_base + pb[i]) * 3 * hidden;
    dp[pu[i]] = dp0[i];
    dp[hidden + pu[i]] = dp1[i];
    dp[2 * hidden + pu[i]] = dp2[i];
  }
}

template <typename T, int R, int UJ>
void* wt_kernel_res(bool resident) {
  return resident ? reinterpret_cast<void*>(lstm_bwd_wtiles<T, R, UJ, true>)
                  : reinterpret_cast<void*>(lstm_bwd_wtiles<T, R, UJ, false>);
}

template <typename T, int R>
void* wt_kernel_uj(int units_per_lane, bool resident) {
  switch (units_per_lane) {
    case 2:
      return wt_kernel_res<T, R, 2>(resident);
    case 5:
      return wt_kernel_res<T, R, 5>(resident);
    default:
      return wt_kernel_res<T, R, 8>(resident);
  }
}

// rows per warp 1 (at most 8 rows per launch) or 8; units per lane 2, 5 or 8
template <typename T>
void* wt_kernel(int rows_per_warp, int units_per_lane, bool resident) {
  return rows_per_warp == 1 ? wt_kernel_uj<T, 1>(units_per_lane, resident)
                            : wt_kernel_uj<T, 8>(units_per_lane, resident);
}

std::mutex wt_mutex;
std::map<std::tuple<int, int, int, int, bool, int>, bool> wt_fits;

// The W-tile layout: the recompute pass over the whole batch, then one
// cooperative launch per chunk of rows_per_launch rows. The tiling (units x
// cols per tile), the rows per launch and the placement come from the
// caller's planner; this checks that they fit (shared memory, the pair
// slots, a co-resident grid).
template <typename T>
int launch_wtiles(const void* gates, const void* mask, const void* w_rec,
                  const void* peep, const void* hprev, const void* cprev,
                  const void* c_seq, const void* dh_seq, const void* dh_f,
                  const void* dc_f, void* dgates, void* dh0, void* dc0,
                  void* dpeep_part, void* zbuf, void* part, int steps,
                  int batch, int hidden, int units, int cols,
                  int rows_per_launch, bool resident, int device,
                  cudaStream_t stream, int* info) {
  const int uj = units / 32;
  if (hidden % 8 != 0 || units % 32 != 0 || (uj != 2 && uj != 5 && uj != 8) ||
      cols < kWtChunk || cols % kWtChunk != 0 ||
      rows_per_launch < 1 || rows_per_launch > kWarps * 8 ||
      zbuf == nullptr || part == nullptr) {
    return kErrBadArgument;
  }
  int unit_tiles = (hidden + units - 1) / units;
  const int col_tiles = (4 * hidden + cols - 1) / cols;
  const int blocks = unit_tiles * col_tiles;
  const int rpw = rows_per_launch <= kWarps ? 1 : 8;
  if (static_cast<long long>(rows_per_launch) * hidden >
      static_cast<long long>(kWtPairs) * blocks * kThreads) {
    return kErrBadArgument;
  }
  const int smem = wt_smem_bytes<T>(units, cols, rpw, resident);
  void* kern = wt_kernel<T>(rpw, uj, resident);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> lock(wt_mutex);
    const auto key = std::make_tuple(static_cast<int>(sizeof(T)), units,
                                     cols, rpw, resident, device);
    auto it = wt_fits.find(key);
    if (it == wt_fits.end()) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      it = wt_fits.emplace(key, blocks <= per_sm * sms).first;
    }
    if (!it->second) return kErrNotCoResident;
  }
  info[0] = blocks;
  info[1] = rpw * kWarps;
  info[2] = resident ? 4 : 3;
  info[3] = smem;
  info[4] = rows_per_launch;
  info[5] = 0;  // launches made
  const int rc = recompute_z(gates, hprev, w_rec, zbuf, steps * batch,
                             hidden, stream, static_cast<const T*>(nullptr));
  if (rc != 0) return rc;
  const T* w = static_cast<const T*>(w_rec);
  const float* p = static_cast<const float*>(peep);
  float* dpp = static_cast<float*>(dpeep_part);
  float* pt = static_cast<float*>(part);
  int stride = batch;
  for (int row0 = 0; row0 < batch; row0 += rows_per_launch) {
    int n = std::min(rows_per_launch, batch - row0);
    const size_t hb = static_cast<size_t>(row0) * hidden;
    const float* zb = static_cast<const float*>(zbuf) + 4 * hb;
    const float* m = static_cast<const float*>(mask) + row0;
    const T* cp = static_cast<const T*>(cprev) + hb;
    const T* cs = static_cast<const T*>(c_seq) + hb;
    const T* dhs = static_cast<const T*>(dh_seq) + hb;
    const T* dhf = static_cast<const T*>(dh_f) + hb;
    const T* dcf = static_cast<const T*>(dc_f) + hb;
    T* dg = static_cast<T*>(dgates) + 4 * hb;
    T* dh = static_cast<T*>(dh0) + hb;
    T* dc = static_cast<T*>(dc0) + hb;
    int base = row0;
    void* args[] = {&zb,  &m,     &w,      &p,     &cp,     &cs,
                    &dhs, &dhf,   &dcf,    &dg,    &dh,     &dc,
                    &dpp, &pt,    &steps,  &n,     &stride, &hidden,
                    &units, &cols, &unit_tiles, &base};
    err = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(kThreads),
                                      args, smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++info[5];
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
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
int launch_unit_tiles(int dtype, const void* gates, const void* mask,
                      const void* w_rec, const void* w_rec_t,
                      const void* peep, const void* hprev, const void* cprev,
                      const void* c_seq, const void* dh_seq, const void* dh_f,
                      const void* dc_f, void* dgates, void* dh0, void* dc0,
                      void* dpeep_part, int steps, int batch, int hidden,
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
// c_seq, dh_seq, dh_f, dc_f, dgates, dh0, dc0); mask, peep, dpeep_part,
// zbuf and part are float32. dpeep_part is [B, 3, H], zero-filled by the
// caller, who sums it over B.
// layout 0 = unit tiles: w_rec_t is w_rec transposed, [4H, H] contiguous;
//   zbuf, part, units, cols, rows and resident are not read (the grid and
//   W placement are chosen here).
// layout 1 = W tiles of ``units`` x ``cols`` (H % 8 == 0), at most ``rows``
//   rows per launch, the tile resident in shared memory (resident 1) or
//   streamed from L2; w_rec_t is not read; zbuf is a [T, B, 4H] workspace,
//   part a [ceil(4H / cols), rows, H] one.
// layout 2 = clusters (H % 8 == 0, H <= 512) of ``rows`` (1, 2, 4, 5, 8)
//   batch rows per block; w_rec_t, part, units, cols and resident are not
//   read; zbuf is a [T, B, 4H] workspace.
// info receives {blocks of a full-chunk launch, batch rows per block, W
// placement (unit tiles: 2 both slices resident, 1 the column slice, 0
// neither; W tiles: 3 streamed from L2, 4 resident; clusters: 5, the row
// slice resident), dynamic shared memory bytes, batch rows per launch,
// launches made (the launches of the recurrence; the recompute pass of
// the W-tile and cluster layouts is part of the call's first)}.
// Returns 0, a cudaError_t value, or one of the negative codes above.
int lstm_seq_bwd(int dtype, const void* gates, const void* mask,
                 const void* w_rec, const void* w_rec_t, const void* peep,
                 const void* hprev, const void* cprev, const void* c_seq,
                 const void* dh_seq, const void* dh_f, const void* dc_f,
                 void* dgates, void* dh0, void* dc0, void* dpeep_part,
                 void* zbuf, void* part, int steps, int batch, int hidden,
                 int layout, int units, int cols, int rows, int resident,
                 int device, void* stream, int* info) {
  if (steps < 1 || batch < 1 || hidden < 1 || (dtype != 0 && dtype != 1) ||
      layout < 0 || layout > 2) {
    return kErrBadArgument;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 2) {
    if (dtype == 0) {
      return launch_cluster_layout<float>(
          gates, mask, w_rec, peep, hprev, cprev, c_seq, dh_seq, dh_f, dc_f,
          dgates, dh0, dc0, dpeep_part, zbuf, steps, batch, hidden, rows, s,
          info);
    }
    return launch_cluster_layout<__nv_bfloat16>(
        gates, mask, w_rec, peep, hprev, cprev, c_seq, dh_seq, dh_f, dc_f,
        dgates, dh0, dc0, dpeep_part, zbuf, steps, batch, hidden, rows, s,
        info);
  }
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return kErrNoCooperative;
  if (layout == 1) {
    if (dtype == 0) {
      return launch_wtiles<float>(gates, mask, w_rec, peep, hprev, cprev,
                                  c_seq, dh_seq, dh_f, dc_f, dgates, dh0,
                                  dc0, dpeep_part, zbuf, part, steps, batch,
                                  hidden, units, cols, rows, resident != 0,
                                  device, s, info);
    }
    return launch_wtiles<__nv_bfloat16>(
        gates, mask, w_rec, peep, hprev, cprev, c_seq, dh_seq, dh_f, dc_f,
        dgates, dh0, dc0, dpeep_part, zbuf, part, steps, batch, hidden, units,
        cols, rows, resident != 0, device, s, info);
  }
  if (dtype == 0) {
    return launch_unit_tiles<float>(dtype, gates, mask, w_rec, w_rec_t, peep,
                                    hprev, cprev, c_seq, dh_seq, dh_f, dc_f,
                                    dgates, dh0, dc0, dpeep_part, steps,
                                    batch, hidden, device, s, info);
  }
  return launch_unit_tiles<__nv_bfloat16>(
      dtype, gates, mask, w_rec, w_rec_t, peep, hprev, cprev, c_seq, dh_seq,
      dh_f, dc_f, dgates, dh0, dc0, dpeep_part, steps, batch, hidden, device,
      s, info);
}

// The card's limits that ops/lstm_kernels.bwd_plan sizes its layouts by
// (sm90::card_limits: SM count, opt-in shared memory per block, clusters
// of 8 and of 16 of this file's cluster kernel held at once). Returns 0 or
// a cudaError_t value.
int lstm_seq_bwd_limits(int device, int* out) {
  return sm90::card_limits(cl_kernel<float>(1, 16), kThreads, device, out);
}

const char* lstm_seq_bwd_error_string(int code) {
  switch (code) {
    case kErrNotCoResident:
      return "no co-resident grid: the batch and hidden size need more "
             "blocks than a cooperative launch can hold";
    case kErrNoCooperative:
      return "device does not support cooperative launches";
    case kErrBadArgument:
      return "bad argument (dtype or layout code, an empty shape, or a W "
             "tiling the layout does not take)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
