// One Hopper tile product with fused epilogues, on TMA and wgmma:
//   C (M, N) = epilogue(A B^T + bias),  A (M, K) and B (N, K) bf16, both
// K-major (rows of x or g, and rows of W1 or W2 in the torch Linear layout:
// wgmma's K-major B as it stands, never transposed). Sums in fp32, one
// rounding to bf16 at the end. Epilogues:
//   - kBiasGelu:     C = bf16(gelu(A B^T + bias)), the exact erff GELU;
//   - kBiasResidual: C = bf16(A B^T + bias (+ res)), res (M, N) bf16 or null.
// The bias is fp32 or bf16 (as the caller holds it), added in fp32.
//
// Shape of a block (csrc/mlp.cu is the first user; kernels 7 and 2):
//   - 128 rows x BN columns (BN 128 or 256) of C: two consumer warpgroups of
//     64 rows, each holding 64 x BN fp32 accumulators, and one producer warp
//     of which one thread issues TMA loads;
//   - K in slices of 64 (one 128-byte swizzle row of bf16): A (128 x 64) and
//     B (BN x 64) tiles by rank-2 tensor maps with 128-byte swizzle into a
//     ring of kStages stages with full (TMA bytes) and empty (eight consumer
//     warps) mbarriers; TMA zero-fills past M, N and K, so ragged tails add
//     nothing and need no padded copy. A row pitch of A or B that is only
//     16-byte aligned slows TMA (attention_models_torch/bench_mlp.py's
//     "rows 16-byte aligned" rows), so the wrappers give the operands of
//     the second product (g, a copy of W2) 64-byte aligned rows;
//   - each slice is four SS wgmma m64nBNk16; a slice's products stay in
//     flight while the next slice's are issued (wgmma_wait<1>), and its stage
//     goes back to the producer when they complete;
//   - the epilogue runs in registers (bias, GELU or residual, masked at M and
//     N), writes bf16 through the freed ring with padded rows (no bank
//     conflicts) and stores 16-byte row pieces below M and N.
// BN 128 runs two blocks an SM (3 stages, at most 112 registers a thread), so
// one block's epilogue overlaps the other's products; BN 256 one block an SM
// (4 stages, up to 224 registers). The host plan (ops/ffn.py::mlp_plan)
// picks BN for each product from its shape and holds the maps' dims, strides
// and boxes, the grid and the shared memory; gemm_from_plan encodes the maps
// and launches. No atomics: every sum runs in one fixed order.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace sm90 {
// Internal linkage: each source that includes this header gets its own
// kernels and launch state (a function-local static of a template with
// external linkage would be one object across every library loaded).
namespace {

constexpr int kBM = 128;       // rows of C a block
constexpr int kBK = 64;        // K a stage
constexpr int kThreads = 288;  // two consumer warpgroups + one producer warp
constexpr int kSwizzle = 128;  // bytes: one row of a K slice
constexpr int kPlanValues = 17;

template <int BN>
struct Config;
template <>
struct Config<128> {
  static constexpr int kStages = 3, kBlocksPerSM = 2;
};
template <>
struct Config<256> {
  static constexpr int kStages = 4, kBlocksPerSM = 1;
};

enum Epilogue { kBiasGelu = 0, kBiasResidual = 1 };

struct GemmArgs {
  const void* bias;            // (N,) fp32, or bf16 when bias_bf16
  const __nv_bfloat16* res;    // kBiasResidual: (M, N) bf16, or null
  __nv_bfloat16* c;            // (M, N) bf16, rows ldc elements apart
  int m, n, k;
  int ldc;                     // row stride of C and res (elements)
  int bias_bf16;
};

// Shared memory; every tile starts on a 1024-byte boundary (the swizzle
// atom): the base is aligned by hand and each tile is a multiple of 1024.
template <int BN>
struct Tiles {
  __nv_bfloat16 a[Config<BN>::kStages][kBM * kBK];
  __nv_bfloat16 b[Config<BN>::kStages][BN * kBK];
  uint64_t full[Config<BN>::kStages], empty[Config<BN>::kStages];
};

template <int BN>
constexpr size_t smem_bytes() {
  return sizeof(Tiles<BN>) + 1024;
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// bias[col], bias[col + 1] (col even) as fp32.
__device__ __forceinline__ float2 bias_pair(const float* b, int col) {
  return *reinterpret_cast<const float2*>(b + col);
}
__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* b, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + col));
}

// The epilogue of a warpgroup's 64 x BN accumulators (rows m0r + 16w + g
// and + 8): bias, then GELU or the residual, in fp32; bf16 into the
// warpgroup's padded staging rows, then 16-byte row pieces below M and N.
template <int BN, int kEpi, typename TB>
__device__ __forceinline__ void epilogue(const float (&acc)[BN / 2],
                                         const GemmArgs& a, const TB* bias,
                                         uint8_t* stage, int m0r, int n0,
                                         int c) {
  constexpr int kRowBytes = 2 * BN + 16;  // padded: no bank conflicts
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
  const int rl = 16 * w + g;  // this thread's rows rl and rl + 8
  const int row0 = m0r + rl, row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int cl = 8 * i + 2 * t, col = n0 + cl;
    if (col >= a.n) continue;  // N % 8 == 0: col + 1 < N as well
    const float2 bb = bias_pair(bias, col);
    float v00 = acc[4 * i] + bb.x, v01 = acc[4 * i + 1] + bb.y;
    float v10 = acc[4 * i + 2] + bb.x, v11 = acc[4 * i + 3] + bb.y;
    if constexpr (kEpi == kBiasGelu) {
      v00 = gelu_exact(v00);
      v01 = gelu_exact(v01);
      v10 = gelu_exact(v10);
      v11 = gelu_exact(v11);
    } else if (a.res != nullptr) {
      if (row0 < a.m) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            a.res + (int64_t)row0 * a.ldc + col));
        v00 += r.x;
        v01 += r.y;
      }
      if (row1 < a.m) {
        const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            a.res + (int64_t)row1 * a.ldc + col));
        v10 += r.x;
        v11 += r.y;
      }
    }
    *reinterpret_cast<uint32_t*>(stage + rl * kRowBytes + cl * 2) =
        pack_bf16x2(v00, v01);
    *reinterpret_cast<uint32_t*>(stage + (rl + 8) * kRowBytes + cl * 2) =
        pack_bf16x2(v10, v11);
  }
  hopper::named_barrier_sync(2 + c, 128);
  constexpr int kChunks = BN / 8;  // 16-byte pieces of a row
#pragma unroll 4
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int row = m0r + r, col = n0 + ch * 8;
    if (row < a.m && col < a.n)
      *reinterpret_cast<uint4*>(a.c + (int64_t)row * a.ldc + col) =
          *reinterpret_cast<const uint4*>(stage + r * kRowBytes + ch * 16);
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    hopper::wgmma_ss_m64n256k16(d, da, db, 1);
  else
    hopper::wgmma_ss_m64n128k16(d, da, db, 1);
}

template <int BN, int kEpi>
__global__ __launch_bounds__(kThreads, Config<BN>::kBlocksPerSM) void gemm_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap, GemmArgs a) {
  using namespace hopper;
  constexpr int S = Config<BN>::kStages;
  constexpr uint32_t kStageBytes = (kBM + BN) * kBK * 2;
  extern __shared__ uint8_t smem_raw[];
  Tiles<BN>& sm = *reinterpret_cast<Tiles<BN>*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int ktiles = (a.k + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      prefetch_tensor_map(&amap);
      prefetch_tensor_map(&bmap);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % S;
        mbar_wait(&sm.empty[st], ((kt / S) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], kStageBytes);
        tma_load_2d(sm.a[st], &amap, &sm.full[st], kt * kBK, m0);
        tma_load_2d(sm.b[st], &bmap, &sm.full[st], kt * kBK, n0);
      }
    }
    return;
  }

  const int c = warp / 4;  // consumer warpgroup: rows 64c.. of the block

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % S;
    mbar_wait(&sm.full[st], (kt / S) & 1);
    const __nv_bfloat16* as = sm.a[st] + c * 64 * kBK;
    const uint64_t da = wgmma_desc<kSwizzle>(as, 8 * kSwizzle);
    const uint64_t db = wgmma_desc<kSwizzle>(sm.b[st], 8 * kSwizzle);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<BN>(acc, desc_advance(da, kk * 32), desc_advance(db, kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products have completed
    if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[(kt - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Both warpgroups' products have completed and no load is in flight: the
  // ring is free for the output staging, 64 padded rows a warpgroup.
  named_barrier_sync(1, 256);
  uint8_t* stage = reinterpret_cast<uint8_t*>(&sm) + c * 64 * (2 * BN + 16);
  if (a.bias_bf16)
    epilogue<BN, kEpi>(acc, a, static_cast<const __nv_bfloat16*>(a.bias), stage,
                       m0 + 64 * c, n0, c);
  else
    epilogue<BN, kEpi>(acc, a, static_cast<const float*>(a.bias), stage,
                       m0 + 64 * c, n0, c);
}

template <int BN, int kEpi>
cudaError_t launch(const CUtensorMap& amap, const CUtensorMap& bmap,
                   const GemmArgs& a, dim3 grid, int64_t smem,
                   cudaStream_t s) {
  static int64_t smem_set = 0;  // the attribute, set once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<BN, kEpi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  gemm_kernel<BN, kEpi><<<grid, kThreads, (size_t)smem, s>>>(amap, bmap, a);
  return cudaGetLastError();
}

// One product from its host plan (kPlanValues int64, ops/ffn.py's
// GemmPlan): the A map's dims (K, M), row bytes and box (64, 128); the B
// map's dims (K, N), row bytes and box (64, BN); the swizzle bytes; the grid
// (N tiles, M tiles); the threads; the dynamic shared memory; BN; C's row
// stride in elements. A plan that does not describe this product, or whose
// maps cuTensorMapEncodeTiled refuses, is an invalid value; nothing is
// launched.
template <int kEpi>
cudaError_t gemm_from_plan(const int64_t* p, const void* A, const void* B,
                           const GemmArgs& a, cudaStream_t s) {
  const int64_t bn = p[15], smem = p[14];
  const bool shape_ok =
      p[0] == a.k && p[1] == a.m && p[5] == a.k && p[6] == a.n &&
      p[3] == kBK && p[4] == kBM && p[8] == kBK && p[9] == bn &&
      p[10] == kSwizzle && p[11] == (a.n + bn - 1) / bn &&
      p[12] == (a.m + kBM - 1) / kBM && p[13] == kThreads && p[16] == a.ldc &&
      a.n % 8 == 0 && a.ldc % 8 == 0 && a.ldc >= a.n;
  if (!shape_ok || (bn != 128 && bn != 256) ||
      smem < (int64_t)(bn == 256 ? smem_bytes<256>() : smem_bytes<128>()) ||
      smem > 232448)
    return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  if (!hopper::encode_bf16_map_2d(&amap, A, p, p[2], (int)p[3], (int)p[4],
                                  kSwizzle) ||
      !hopper::encode_bf16_map_2d(&bmap, B, p + 5, p[7], (int)p[8], (int)p[9],
                                  kSwizzle))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)p[11], (unsigned)p[12]);
  return bn == 256 ? launch<256, kEpi>(amap, bmap, a, grid, smem, s)
                   : launch<128, kEpi>(amap, bmap, a, grid, smem, s);
}

}  // namespace
}  // namespace sm90
