// Tile products and block reductions shared by the GEGLU FFN and head
// kernels (csrc/ffn.cu, csrc/ffn_bwd.cu, csrc/xent.cu): C (M x N) = A B
// over K, with A an (M, K) view and B an (N, K) view of device memory, each
// in one of two layouts:
//   kK: element (r, k) at p[r * ld + k]  (contiguous along k: x, W1 rows)
//   kR: element (r, k) at p[k * ld + r]  (contiguous along r: a (K, R)
//       array read transposed, as dy^T in dW2 = dy^T y)
// so one kernel serves x W^T, dy W and the A^T B weight gradients.
//
// bf16: 128 x 128 output tiles, 256 threads (8 warps of 64 x 32), mma.sync
// m16n8k16 with fp32 accumulators, 32-deep K slices copied as they lie in
// device memory by cp.async (three stages). A kK tile keeps its rows in
// shared memory ([r][k]) and feeds the fragments with 32-bit loads; a kR
// tile keeps [k][r] and feeds them element by element (load_a_frag /
// load_b_frag). fp32: 64 x 64 tiles of exact FMA products, 16-deep K
// slices, each thread rows ty + 16 i and columns tx + 16 j. Rows and
// columns past M, N and K are zero-filled, so K adds nothing there.
// Requirements: M, N, K and every ld multiples of 8, operands 16-byte
// aligned. Simple tiles, right first: wgmma and TMA are later work.
#pragma once

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Layout { kK = 0, kR = 1 };

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 3;
constexpr int kLdK = kBK + 8;  // shared row stride of a kK tile [r][k]
constexpr int kLdR = kBM + 8;  // shared row stride of a kR tile [k][r]
constexpr int kTileElems = kBM * kLdK;  // >= kBK * kLdR
constexpr size_t kTileSmem = sizeof(bf16) * kStages * 2 * kTileElems;

// The (128 r x 32 k) slice at (r0, k0) of operand p into the shared tile s,
// zero past R or K: two 16-byte cp.async per thread.
template <int L>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* p, int ld, int R,
                                          int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = threadIdx.x + i * kThreads;
    if (L == kK) {
      const int r = id >> 2, kc = (id & 3) * 8;
      const bool ok = r0 + r < R && k0 + kc < K;
      cp_async16(s + r * kLdK + kc, ok ? p + (int64_t)(r0 + r) * ld + k0 + kc : p, ok);
    } else {
      const int k = id >> 4, rc = (id & 15) * 8;
      const bool ok = k0 + k < K && r0 + rc < R;
      cp_async16(s + k * kLdR + rc, ok ? p + (int64_t)(k0 + k) * ld + r0 + rc : p, ok);
    }
  }
}

// mma fragments of a shared tile: A rows m..m+15, B columns n..n+7, both
// at depth k..k+15 (layouts in common.cuh)
template <int L>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s, int m, int k) {
  if (L == kK) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const bf16* p = s + (m + g) * kLdK + k + 2 * t;
    a[0] = *reinterpret_cast<const uint32_t*>(p);
    a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdK);
    a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdK + 8);
  } else {
    load_a_frag(a, s + k * kLdR + m, 1, kLdR);
  }
}
template <int L>
__device__ __forceinline__ void frag_b(uint32_t b[2], const bf16* s, int n, int k) {
  if (L == kK) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const bf16* p = s + (n + g) * kLdK + k + 2 * t;
    b[0] = *reinterpret_cast<const uint32_t*>(p);
    b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
  } else {
    load_b_frag(b, s + k * kLdR + n, kLdR, 1);
  }
}

// acc = this warp's 64 x 32 part of the 128 x 128 tile at (m0, n0) of A B:
// warp w holds rows m0 + (w / 4) * 64 + mt * 16 + g (+ 8) and columns
// n0 + (w % 4) * 32 + nt * 8 + 2t (+ 1) in acc[mt][nt][0..3] (the m16n8 C
// layout). smem: kTileSmem bytes; callable again for another tile.
template <int LA, int LB>
__device__ void mma_tile(const bf16* A, int lda, int M, const bf16* B, int ldb,
                         int N, int K, int m0, int n0, bf16* smem,
                         float acc[4][4][4]) {
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int KT = (K + kBK - 1) / kBK;
  __syncthreads();  // no thread still reads an earlier tile's slices
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) {
      bf16* st = smem + s * 2 * kTileElems;
      load_tile<LA>(st, A, lda, M, K, m0, s * kBK);
      load_tile<LB>(st + kTileElems, B, ldb, N, K, n0, s * kBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed for this thread
    __syncthreads();               // ... for every thread; slice kt-1 is done
    const int nk = kt + kStages - 1;
    if (nk < KT) {
      bf16* st = smem + (nk % kStages) * 2 * kTileElems;
      load_tile<LA>(st, A, lda, M, K, m0, nk * kBK);
      load_tile<LB>(st + kTileElems, B, ldb, N, K, n0, nk * kBK);
    }
    cp_async_commit();
    const bf16* at = smem + (kt % kStages) * 2 * kTileElems;
    const bf16* bt = at + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) frag_a<LA>(af[mt], at, wm * 64 + mt * 16, kk);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) frag_b<LB>(bfr[nt], bt, wn * 32 + nt * 8, kk);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

template <int LA, int LB, typename OutT>
__global__ __launch_bounds__(kThreads) void gemm_bf16_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    OutT* __restrict__ C, int ldc, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4][4];
  mma_tile<LA, LB>(A, lda, M, B, ldb, N, K, m0, n0,
                   reinterpret_cast<bf16*>(smem_raw), acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col < N)
          store2(C + (int64_t)row * ldc + col, acc[mt][nt][2 * half],
                 acc[mt][nt][2 * half + 1]);
      }
    }
}

template <int LA, int LB, typename OutT>
cudaError_t gemm_bf16(const bf16* A, int lda, const bf16* B, int ldb, OutT* C,
                      int ldc, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<LA, LB, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTileSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_bf16_kernel<LA, LB, OutT><<<grid, kThreads, kTileSmem, s>>>(A, lda, B, ldb, C, ldc,
                                                                    M, N, K);
  return cudaGetLastError();
}

// ---- fp32: exact FMA products --------------------------------------------
constexpr int kFM = 64, kFN = 64, kFK = 16;
typedef float FTile[kFK][kFM + 4];  // [k][r]

template <int L>
__device__ __forceinline__ float4 f32_fetch(const float* p, int ld, int R, int K,
                                            int r0, int k0) {
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (L == kK) {
    const int r = tid >> 2, kc = (tid & 3) * 4;
    return r0 + r < R && k0 + kc < K
               ? *reinterpret_cast<const float4*>(p + (int64_t)(r0 + r) * ld + k0 + kc)
               : zero;
  }
  const int k = tid >> 4, rc = (tid & 15) * 4;
  return k0 + k < K && r0 + rc < R
             ? *reinterpret_cast<const float4*>(p + (int64_t)(k0 + k) * ld + r0 + rc)
             : zero;
}
template <int L>
__device__ __forceinline__ void f32_store(FTile& xs, float4 v) {
  const int tid = threadIdx.x;
  if (L == kK) {
    const int r = tid >> 2, kc = (tid & 3) * 4;
    xs[kc][r] = v.x;
    xs[kc + 1][r] = v.y;
    xs[kc + 2][r] = v.z;
    xs[kc + 3][r] = v.w;
  } else {
    const int k = tid >> 4, rc = (tid & 15) * 4;
    *reinterpret_cast<float4*>(&xs[k][rc]) = v;
  }
}

// acc[i][j] = (A B)[m0 + ty + 16 i][n0 + tx + 16 j], tx = tid % 16, ty =
// tid / 16; the K loop runs in order
template <int LA, int LB>
__device__ void fma_tile(const float* A, int lda, int M, const float* B, int ldb,
                         int N, int K, int m0, int n0, FTile& as, FTile& bs,
                         float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    const float4 av = f32_fetch<LA>(A, lda, M, K, m0, k0);
    const float4 bv = f32_fetch<LB>(B, ldb, N, K, n0, k0);
    __syncthreads();  // the previous slice (or tile) is consumed
    f32_store<LA>(as, av);
    f32_store<LB>(bs, bv);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }
}

template <int LA, int LB>
__global__ __launch_bounds__(kThreads) void gemm_f32_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    float* __restrict__ C, int ldc, int M, int N, int K) {
  __shared__ __align__(16) FTile as, bs;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  float acc[4][4];
  fma_tile<LA, LB>(A, lda, M, B, ldb, N, K, m0, n0, as, bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) C[(int64_t)row * ldc + col] = acc[i][j];
    }
  }
}

template <int LA, int LB>
cudaError_t gemm_f32(const float* A, int lda, const float* B, int ldb, float* C,
                     int ldc, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  gemm_f32_kernel<LA, LB><<<grid, kThreads, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K);
  return cudaGetLastError();
}

// Sum over the block (kThreads threads), the same value in every thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by an earlier call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// out[c] = sum over r of part[r][c], in order (the deterministic second
// stage of a cross-block column sum)
__global__ void colsum_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(int64_t)r * cols + c];
  out[c] = s;
}

inline cudaError_t colsum(const float* part, float* out, int rows, int cols,
                          cudaStream_t s) {
  colsum_kernel<<<(cols + 255) / 256, 256, 0, s>>>(part, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace
