// The product step of the recurrent forward kernels' cluster layout
// (csrc/lstm_seq_fwd.cu, csrc/gru_seq_fwd.cu, each compiled on its own).
//
// A cluster block owns 32 hidden units (one unit tile) for R batch rows,
// and each step it forms, for those R rows, the products of the full
// previous state x [R, K] (h_{t-1}, or the GRU's round(r * h_{t-1}), held
// in float32 in its own shared memory, rows at a pitch of xp floats) with
// its NC columns of a recurrent weight: block column c = q * 32 + l is
// column q * H + u0 + l of a W of NC / 32 * H columns (the LSTM: its four
// gates, NC = 128; the GRU: W_rz's u and r columns, NC = 64, and W_c's,
// NC = 32). The block's slice of W stays on chip for the whole launch:
//
//   float32: CUDA cores in full float32; K = H is split over the 8 warps,
//     lane l takes block columns l + 32q for all R rows, reading x as
//     float4 broadcasts; the warps' partial sums go to the scratch and are
//     summed in warp order by ``sum``.
//   bfloat16: tensor cores, mma.sync.m16n8k16 with float32 accumulators
//     (products of bf16 values are exact in float32): the R rows are the
//     first rows of one m16 tile (the others zero), each warp takes one or
//     two n8 tiles of columns over all of K, or, with fewer than 8 n-tiles,
//     one n-tile over half of K (the halves summed in order by ``sum``);
//     even and odd k16 steps accumulate apart (two chains of dependent
//     products, not one) and are summed once.
//
// kRegW (H <= 256: 8 unit tiles, K padded with zeros to 256): the slice
// sits in registers (float32: a thread's 32 x NC / 32 values; bfloat16:
// its B fragments), loaded once from global memory, so that the step reads
// only x from shared memory (as the backward's cluster kernels do: there,
// shared-memory W loads did not overlap the FMAs). Else (up to 16
// unit tiles) the slice is in shared memory, K = H rounded up to 32:
// float32 [K][NC], bfloat16 in fragment order [K / 16][NC / 8][32 lanes]
// (one conflict-free 8-byte load per fragment).
//
// Every sum runs in a fixed order: a repeat is the same bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_cluster.cuh"
#include "sm90_mma.cuh"

namespace fwdcl {

constexpr int kUnits = 32;  // hidden units per block (one unit tile)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRegK = kWarps * kUnits;  // K of the register path
constexpr int kMaxTiles = 16;           // blocks per cluster, at most
constexpr int kXPad = 8;  // floats past K in a row of x (A-fragment banks)

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr bool reg_w(int tiles) {
  return tiles <= sm90::kPortableClusterSize;
}

// K of a block's product, and the pitch of a row of x in floats
__host__ __device__ constexpr int k_len(int tiles) {
  return reg_w(tiles) ? kRegK : tiles * kUnits;
}
__host__ __device__ constexpr int x_pitch(int tiles) {
  return k_len(tiles) + kXPad;
}

// bytes of a block's W slice of nc columns in shared memory (0 where it
// sits in registers)
__host__ __device__ constexpr int w_bytes(int tiles, int nc, int elem_bytes) {
  return reg_w(tiles) ? 0 : k_len(tiles) * nc * elem_bytes;
}

// floats of the scratch of an nc-column product at R rows
__host__ __device__ constexpr int scratch_floats(int nc, int rows,
                                                 int elem_bytes) {
  return elem_bytes == 4
             ? kWarps * nc * rows
             : (nc / 8 >= kWarps ? 1 : kWarps / (nc / 8)) * nc * rows;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int R, int NC, bool kRegW>
struct Product {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int NQ = NC / kUnits;  // groups of 32 columns
  static constexpr int NT = NC / 8;       // n8 tiles
  static constexpr int KS = NT >= kWarps ? 1 : kWarps / NT;  // K parts
  static constexpr int NPW = NT >= kWarps ? NT / kWarps : 1;  // tiles/warp
  static constexpr int kRegSteps = kRegK / 16 / KS;  // k16 steps of a warp
  static_assert(NC % kUnits == 0 && R >= 1 && R <= 8, "block shape");

  float wr[(kRegW && !kMma) ? kUnits * NQ : 1];
  uint32_t br[(kRegW && kMma) ? kRegSteps * NPW * 2 : 1];
  const void* ws = nullptr;  // the slice in shared memory
  int k = 0;                 // K of the product

  __device__ static int warp_nt(int warp) {
    return NT >= kWarps ? warp * NPW : warp % NT;
  }
  __device__ static int warp_kpart(int warp) {
    return NT >= kWarps ? 0 : warp / NT;
  }

  // W[k, column of block column c], zero past H
  __device__ static float wval(const T* w, int hidden, int u0, int kk,
                               int c) {
    const int u = u0 + c % kUnits;
    return kk < hidden && u < hidden
               ? to_f(w[static_cast<size_t>(kk) * NQ * hidden +
                        (c / kUnits) * hidden + u])
               : 0.f;
  }
  // the bfloat16 pair W[kk, c], W[kk + 1, c] (exact: W is bfloat16)
  __device__ static uint32_t wpair(const T* w, int hidden, int u0, int kk,
                                   int c) {
    return sm90::pack_bf16(make_float2(wval(w, hidden, u0, kk, c),
                                       wval(w, hidden, u0, kk + 1, c)));
  }

  // This block's slice of ``w`` ([H, NQ * H]) for units u0 .. u0 + 31:
  // into registers, or into ``smem`` (w_bytes bytes). The caller's block
  // barrier follows before ``run``.
  __device__ void load(const T* w, int hidden, int u0, int tiles,
                       unsigned char* smem) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    k = k_len(tiles);
    if constexpr (kRegW && !kMma) {
#pragma unroll
      for (int kk = 0; kk < kUnits; ++kk)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          wr[kk * NQ + q] =
              wval(w, hidden, u0, warp * kUnits + kk, q * kUnits + lane);
    } else if constexpr (kRegW) {
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int j = 0; j < kRegSteps; ++j)
#pragma unroll
        for (int p = 0; p < NPW; ++p) {
          const int ks = warp_kpart(warp) * kRegSteps + j;
          const int c = (warp_nt(warp) + p) * 8 + g;
          br[(j * NPW + p) * 2] = wpair(w, hidden, u0, 16 * ks + 2 * t, c);
          br[(j * NPW + p) * 2 + 1] =
              wpair(w, hidden, u0, 16 * ks + 2 * t + 8, c);
        }
    } else if constexpr (!kMma) {
      float* s = reinterpret_cast<float*>(smem);
      for (int e = threadIdx.x; e < k * NC; e += kThreads) {
        s[e] = wval(w, hidden, u0, e / NC, e % NC);
      }
      ws = smem;
    } else {
      uint2* s = reinterpret_cast<uint2*>(smem);
      for (int e = threadIdx.x; e < k / 16 * NT * 32; e += kThreads) {
        const int l = e % 32;
        const int nt = (e / 32) % NT;
        const int ks = e / (32 * NT);
        const int c = nt * 8 + l / 4;
        s[e] = make_uint2(wpair(w, hidden, u0, 16 * ks + 2 * (l % 4), c),
                          wpair(w, hidden, u0, 16 * ks + 2 * (l % 4) + 8, c));
      }
      ws = smem;
    }
  }

  // scratch <- this block's products of the R rows of x (x[r * xp + k],
  // float32, zero past H) with its slice; ends with a block barrier, after
  // which ``sum`` reads them.
  __device__ void run(const float* x, int xp, float* scratch) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if constexpr (!kMma) {
      float acc[NQ][R];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] = 0.f;
      if constexpr (kRegW) {
        const float* xw = x + warp * kUnits;
#pragma unroll
        for (int kk = 0; kk < kUnits; kk += 4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 hv = sm90::load4(xw + r * xp + kk);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              acc[q][r] = fmaf(hv.x, wr[kk * NQ + q], acc[q][r]);
              acc[q][r] = fmaf(hv.y, wr[(kk + 1) * NQ + q], acc[q][r]);
              acc[q][r] = fmaf(hv.z, wr[(kk + 2) * NQ + q], acc[q][r]);
              acc[q][r] = fmaf(hv.w, wr[(kk + 3) * NQ + q], acc[q][r]);
            }
          }
        }
      } else {
        const int ks = k / kWarps;
        const float* wsf = static_cast<const float*>(ws) + lane;
        for (int kk = warp * ks; kk < (warp + 1) * ks; kk += 4) {
          float wv[4][NQ];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              wv[i][q] = wsf[(kk + i) * NC + q * kUnits];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 hv = sm90::load4(x + r * xp + kk);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              acc[q][r] = fmaf(hv.x, wv[0][q], acc[q][r]);
              acc[q][r] = fmaf(hv.y, wv[1][q], acc[q][r]);
              acc[q][r] = fmaf(hv.z, wv[2][q], acc[q][r]);
              acc[q][r] = fmaf(hv.w, wv[3][q], acc[q][r]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r)
          scratch[((warp * NQ + q) * R + r) * kUnits + lane] = acc[q][r];
    } else {
      const int g = lane / 4, t = lane % 4;
      const int steps = k / 16 / KS;
      const int ks0 = warp_kpart(warp) * steps;
      const int nt0 = warp_nt(warp);
      // rows past R (and rows 8-15 of the m16 tile) are zero
      const float* xa = x + min(g, R - 1) * xp + 2 * t;
      const uint2* wf = static_cast<const uint2*>(ws);
      // two accumulator sets per n-tile, even and odd k16 steps, summed
      // at the end: half the chain of dependent products
      float d[2][NPW][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < NPW; ++p)
          d[h][p][0] = d[h][p][1] = d[h][p][2] = d[h][p][3] = 0.f;
      auto kstep = [&](int j, float (&acc)[NPW][4]) {
        const int ks = ks0 + j;
        const uint32_t a[4] = {
            g < R ? sm90::pack_bf16(sm90::load2(xa + 16 * ks)) : 0u, 0u,
            g < R ? sm90::pack_bf16(sm90::load2(xa + 16 * ks + 8)) : 0u, 0u};
#pragma unroll
        for (int p = 0; p < NPW; ++p) {
          uint32_t b0, b1;
          if constexpr (kRegW) {
            b0 = br[(j * NPW + p) * 2];
            b1 = br[(j * NPW + p) * 2 + 1];
          } else {
            const uint2 v = wf[(ks * NT + nt0 + p) * 32 + lane];
            b0 = v.x;
            b1 = v.y;
          }
          sm90::mma_bf16(acc[p], a, b0, b1);
        }
      };
      if constexpr (kRegW) {
#pragma unroll
        for (int j = 0; j < kRegSteps; j += 2) {
          kstep(j, d[0]);
          kstep(j + 1, d[1]);
        }
      } else {
        int j = 0;
        for (; j + 1 < steps; j += 2) {
          kstep(j, d[0]);
          kstep(j + 1, d[1]);
        }
        if (j < steps) kstep(j, d[0]);
      }
      if (g < R) {
#pragma unroll
        for (int p = 0; p < NPW; ++p) {
          float* o = scratch + (warp_kpart(warp) * R + g) * NC +
                     (nt0 + p) * 8 + 2 * t;
          o[0] = d[0][p][0] + d[1][p][0];
          o[1] = d[0][p][1] + d[1][p][1];
        }
      }
    }
    __syncthreads();
  }

  // the product of row r, block column c: the partial sums in order
  __device__ static float sum(const float* scratch, int r, int c) {
    float s = 0.f;
    if constexpr (!kMma) {
      const int q = c / kUnits, l = c % kUnits;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += scratch[((w * NQ + q) * R + r) * kUnits + l];
      }
    } else {
#pragma unroll
      for (int kp = 0; kp < KS; ++kp) s += scratch[(kp * R + r) * NC + c];
    }
    return s;
  }
};

}  // namespace fwdcl
