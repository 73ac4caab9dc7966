// The fp32 flash kernels' register-tiled building blocks, shared by the
// forward (csrc/flash_attention.cu: flash_fwd_f32_kernel) and the backward
// (csrc/flash_attention_bwd.cu: flash_bwd_dkv_f32_kernel,
// flash_bwd_dq_f32_kernel). wgmma has no fp32 operands and TF32 would break
// the 1e-5 gate, so these are a small SIMT GEMM: 128 threads own 64 rows
// of one side (query rows, or keys) in shared memory; the other side
// streams in chunks of 32 rows, copied by 16-byte cp.async into padded
// rows of D + 4 floats (conflict-free float4 reads). Thread tid holds a
// 4 x 4 micro-tile of a chunk's scores (rows 4*(tid/8) + i, streamed rows
// tid%8 + 8j: a row's 32 scores lie with 8 adjacent lanes) and a 4 x D/8
// slice of an accumulator (rows 4*(tid/8) + i, columns 4*(tid%8) + 32m..).
// Every sum runs over its terms in one fixed order by fmaf.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kF32Own = 64;     // rows a block owns (query rows or keys)
constexpr int kF32Chunk = 32;   // streamed rows a chunk
constexpr int kF32Threads = 128;

// 4-byte asynchronous copy global -> shared.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(smem)),
               "l"(gmem));
}

// rows [r0, r0 + rows) of a d-wide fp32 operand (row stride `stride`
// elements) into shared rows of D + 4 floats by 16-byte cp.async; rows at or
// past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int64_t stride, int r0,
                                              int rows, int limit) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < rows * C; idx += kF32Threads) {
    const int r = idx / C, c = idx % C, row = r0 + r;
    const bool ok = row < limit;
    cp_async16(dst + r * (D + 4) + 4 * c,
               src + (int64_t)(ok ? row : 0) * stride + 4 * c, ok);
  }
}

// The 4 x 4 micro-tiles of kN products x = A1 B1^T (and, for kN 2,
// y = A2 B2^T) over D: rows 4*(tid/8) + i of the A tiles, rows tid%8 + 8j
// of the B tiles, all of row stride D + 4 in shared memory (float4 reads:
// broadcast for A, distinct bank groups for B).
template <int D, int kN>
__device__ __forceinline__ void micro_products(float (&x)[4][4],
                                               float (&y)[4][4],
                                               const float* a1, const float* a2,
                                               const float* b1, const float* b2) {
  constexpr int P = D + 4;
  const int ar = 4 * (threadIdx.x / 8), br = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[i][j] = 0.f;
      if constexpr (kN == 2) y[i][j] = 0.f;
    }
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 va[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      va[i] = *reinterpret_cast<const float4*>(a1 + (ar + i) * P + c);
      vb[i] = *reinterpret_cast<const float4*>(b1 + (br + 8 * i) * P + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(va[i].x, vb[j].x, x[i][j]);
        x[i][j] = fmaf(va[i].y, vb[j].y, x[i][j]);
        x[i][j] = fmaf(va[i].z, vb[j].z, x[i][j]);
        x[i][j] = fmaf(va[i].w, vb[j].w, x[i][j]);
      }
    if constexpr (kN == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        va[i] = *reinterpret_cast<const float4*>(a2 + (ar + i) * P + c);
        vb[i] = *reinterpret_cast<const float4*>(b2 + (br + 8 * i) * P + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[i][j] = fmaf(va[i].x, vb[j].x, y[i][j]);
          y[i][j] = fmaf(va[i].y, vb[j].y, y[i][j]);
          y[i][j] = fmaf(va[i].z, vb[j].z, y[i][j]);
          y[i][j] = fmaf(va[i].w, vb[j].w, y[i][j]);
        }
    }
  }
}

// Two products (the backward's S and dP, or their transposes).
template <int D>
__device__ __forceinline__ void micro_abt(float (&x)[4][4], float (&y)[4][4],
                                          const float* a1, const float* a2,
                                          const float* b1, const float* b2) {
  micro_products<D, 2>(x, y, a1, a2, b1, b2);
}

// One product (the forward's S).
template <int D>
__device__ __forceinline__ void micro_abt(float (&x)[4][4], const float* a,
                                          const float* b) {
  micro_products<D, 1>(x, x, a, a, b, b);
}

// o[i][4m + e] += sum over r < kF32Chunk of p[r][4*(tid/8) + i] *
// b[r][4*(tid%8) + 32m + e]: p rows of kF32Own + 4 floats, b rows of D + 4.
template <int D>
__device__ __forceinline__ void micro_atb(float (&o)[4][D / 8],
                                          const float* p, const float* b) {
  const int pc = 4 * (threadIdx.x / 8), bc = 4 * (threadIdx.x % 8);
#pragma unroll 4
  for (int r = 0; r < kF32Chunk; ++r) {
    const float4 pv = *reinterpret_cast<const float4*>(p + r * (kF32Own + 4) +
                                                       pc);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const float4 bv = *reinterpret_cast<const float4*>(b + r * (D + 4) +
                                                         bc + 32 * m);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i][4 * m] = fmaf(pr[i], bv.x, o[i][4 * m]);
        o[i][4 * m + 1] = fmaf(pr[i], bv.y, o[i][4 * m + 1]);
        o[i][4 * m + 2] = fmaf(pr[i], bv.z, o[i][4 * m + 2]);
        o[i][4 * m + 3] = fmaf(pr[i], bv.w, o[i][4 * m + 3]);
      }
    }
  }
}

// The 4 x d/8 slice o of rows 4*(tid/8) + i, columns 4*(tid%8) + 32m.., times
// s, stored below `limit` rows (row stride `stride`).
template <int D>
__device__ __forceinline__ void store_slice(float* dst, int64_t stride,
                                            int r0, int limit,
                                            const float (&o)[4][D / 8],
                                            float s) {
  const int rr = r0 + 4 * (threadIdx.x / 8), cc = 4 * (threadIdx.x % 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rr + i >= limit) continue;
#pragma unroll
    for (int m = 0; m < D / 32; ++m)
      *reinterpret_cast<float4*>(dst + (rr + i) * stride + cc + 32 * m) =
          make_float4(o[i][4 * m] * s, o[i][4 * m + 1] * s,
                      o[i][4 * m + 2] * s, o[i][4 * m + 3] * s);
  }
}

}  // namespace
