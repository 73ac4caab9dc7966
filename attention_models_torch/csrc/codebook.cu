// Nearest codebook entry: idx[i] = argmin_j (|e_j|^2 - 2 z_i . e_j).
//
// Replaces attention_models_tpu/ops/codebook.py::_nn_kernel (entry
// nearest_codes). The |z_i|^2 term is constant per token and dropped, as
// there.
//
// Bound on the H100: operations. At the main path's 8192 tokens x 8192 codes
// x 32 dims the products are 4.3 GFLOP against 1 MB of operands, about 4 us
// at the bf16 tensor-core peak. This kernel does the dots as fp32 FMAs on the
// CUDA cores (67 TFLOP/s peak), so it cannot come closer than ~64 us; moving
// the dots to mma.sync is later work.
//
// Design: a block of 128 threads takes a tile of 128 tokens through shared
// memory into registers (one token per thread) and one slice of the codebook
// (grid.y splits it into slices of `split` codes, so 8192 tokens still fill
// the card with blocks). The slice streams through shared memory in chunks of
// 128 codes, with |e|^2 computed once per chunk. Every thread reads the same
// code at the same time (a shared-memory broadcast). Each thread keeps a
// running (min, argmin) over its slice in ascending order with a strict '<';
// a second small kernel combines the slices' pairs per token in ascending
// slice order with a strict '<' too, so the first lowest index wins ties, as
// torch.argmin and the TPU kernel do. bf16 operands are widened to fp32 on
// load: a bf16 x bf16 product is exact in fp32, so this is "bf16 operands,
// fp32 accumulation"; fp32 operands give exact fp32 dots.
//
// Widths. The token-in-registers kernel is instantiated for code widths 8,
// 16, 32 and 64 (at 64 its static shared buffer is 33 KB of the 48 KB
// limit). Any other width, as the JAX package computes every width, runs
// nearest_codes_any_kernel: the same blocks, slices and tie rule, with the
// width taken in 32-wide steps through shared memory (a 128 x 32 token
// slice and 32 codes at a time), each thread keeping 32 running dots in
// registers; every dot still sums its products in ascending width order.
#include "common.cuh"

namespace {

constexpr int kTokens = 128;
constexpr int kCodes = 128;
constexpr int kSlice = 32;  // width step and codes per step of the any-width kernel

template <typename T, int D>
__global__ __launch_bounds__(kTokens) void nearest_codes_kernel(
    const T* __restrict__ z, const T* __restrict__ codes,
    float* __restrict__ part_d, int* __restrict__ part_i, int n, int k,
    int split) {
  // The token tile (rows padded to D + 1 against bank conflicts) and the code
  // chunks share one buffer: the tile is only read before the first chunk.
  constexpr int kBuf = kTokens * (D + 1) > kCodes * D ? kTokens * (D + 1)
                                                      : kCodes * D;
  __shared__ __align__(16) float buf[kBuf];
  __shared__ float esq[kCodes];
  float* zs = buf;
  float* cs = buf;

  const int tid = threadIdx.x;
  const int tok0 = blockIdx.x * kTokens;
  for (int i = tid; i < kTokens * D; i += kTokens) {
    const int r = i / D, c = i % D;
    zs[r * (D + 1) + c] =
        tok0 + r < n ? to_f32<T>(z[(int64_t)(tok0 + r) * D + c]) : 0.f;
  }
  __syncthreads();
  float zr[D];
#pragma unroll
  for (int c = 0; c < D; ++c) zr[c] = zs[tid * (D + 1) + c];

  const int c_end = min(k, (blockIdx.y + 1) * split);
  float best = INFINITY;
  int best_idx = blockIdx.y * split;
  for (int c0 = blockIdx.y * split; c0 < c_end; c0 += kCodes) {
    const int m = min(kCodes, c_end - c0);
    __syncthreads();  // the previous chunk is no longer read
#pragma unroll 8
    for (int i = tid; i < m * D; i += kTokens) {
      cs[i] = to_f32<T>(codes[(int64_t)c0 * D + i]);
    }
    __syncthreads();
    // |e|^2: one warp per code, lanes over the dims (no bank conflicts)
    for (int j = tid / 32; j < m; j += kTokens / 32) {
      float s = 0.f;
      for (int c = tid % 32; c < D; c += 32) s = fmaf(cs[j * D + c], cs[j * D + c], s);
      s = warp_sum(s);
      if (tid % 32 == 0) esq[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4* e4 = reinterpret_cast<const float4*>(cs + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 e = e4[c];
        dot = fmaf(zr[4 * c + 0], e.x, dot);
        dot = fmaf(zr[4 * c + 1], e.y, dot);
        dot = fmaf(zr[4 * c + 2], e.z, dot);
        dot = fmaf(zr[4 * c + 3], e.w, dot);
      }
      const float dist = esq[j] - 2.f * dot;
      if (dist < best) {
        best = dist;
        best_idx = c0 + j;
      }
    }
  }
  if (tok0 + tid < n) {
    part_d[(int64_t)(tok0 + tid) * gridDim.y + blockIdx.y] = best;
    part_i[(int64_t)(tok0 + tid) * gridDim.y + blockIdx.y] = best_idx;
  }
}

// One thread per token: the first lowest of the slices' (min, argmin) pairs.
__global__ void combine_kernel(const float* __restrict__ part_d,
                               const int* __restrict__ part_i,
                               int* __restrict__ out, int n, int slices) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best = part_d[(int64_t)i * slices];
  int best_idx = part_i[(int64_t)i * slices];
  for (int s = 1; s < slices; ++s) {
    const float v = part_d[(int64_t)i * slices + s];
    if (v < best) {
      best = v;
      best_idx = part_i[(int64_t)i * slices + s];
    }
  }
  out[i] = best_idx;
}

template <typename T>
__global__ __launch_bounds__(kTokens) void nearest_codes_any_kernel(
    const T* __restrict__ z, const T* __restrict__ codes,
    float* __restrict__ part_d, int* __restrict__ part_i, int n, int k, int d,
    int split) {
  __shared__ float zs[kTokens][kSlice + 1];  // padded against bank conflicts
  __shared__ float cs[kSlice][kSlice];       // read as a broadcast
  __shared__ float esq[kSlice];
  const int tid = threadIdx.x;
  const int tok0 = blockIdx.x * kTokens;
  const int c_end = min(k, (blockIdx.y + 1) * split);
  float best = INFINITY;
  int best_idx = blockIdx.y * split;
  for (int c0 = blockIdx.y * split; c0 < c_end; c0 += kSlice) {
    const int m = min(kSlice, c_end - c0);
    float dot[kSlice];
#pragma unroll
    for (int j = 0; j < kSlice; ++j) dot[j] = 0.f;
    float e2 = 0.f;
    for (int d0 = 0; d0 < d; d0 += kSlice) {
      __syncthreads();  // the previous slices are no longer read
      for (int i = tid; i < kTokens * kSlice; i += kTokens) {
        const int r = i / kSlice, c = i % kSlice;
        zs[r][c] = tok0 + r < n && d0 + c < d
                       ? to_f32<T>(z[(int64_t)(tok0 + r) * d + d0 + c]) : 0.f;
      }
      for (int i = tid; i < kSlice * kSlice; i += kTokens) {
        const int j = i / kSlice, c = i % kSlice;
        cs[j][c] = j < m && d0 + c < d
                       ? to_f32<T>(codes[(int64_t)(c0 + j) * d + d0 + c]) : 0.f;
      }
      __syncthreads();
      if (tid < kSlice) {
#pragma unroll
        for (int c = 0; c < kSlice; ++c) e2 = fmaf(cs[tid][c], cs[tid][c], e2);
      }
      float zr[kSlice];
#pragma unroll
      for (int c = 0; c < kSlice; ++c) zr[c] = zs[tid][c];
#pragma unroll
      for (int j = 0; j < kSlice; ++j)
#pragma unroll
        for (int c = 0; c < kSlice; ++c) dot[j] = fmaf(zr[c], cs[j][c], dot[j]);
    }
    if (tid < kSlice) esq[tid] = e2;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSlice; ++j) {
      const float dist = esq[j] - 2.f * dot[j];
      if (j < m && dist < best) {
        best = dist;
        best_idx = c0 + j;
      }
    }
  }
  if (tok0 + tid < n) {
    part_d[(int64_t)(tok0 + tid) * gridDim.y + blockIdx.y] = best;
    part_i[(int64_t)(tok0 + tid) * gridDim.y + blockIdx.y] = best_idx;
  }
}

template <typename T>
cudaError_t launch(const T* z, const T* codes, float* part_d, int* part_i,
                   int* out, int n, int k, int d, int split,
                   cudaStream_t stream) {
  const int slices = (k + split - 1) / split;
  const dim3 grid((n + kTokens - 1) / kTokens, slices);
  if (d <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 8:
      nearest_codes_kernel<T, 8><<<grid, kTokens, 0, stream>>>(z, codes, part_d, part_i, n,
                                                               k, split);
      break;
    case 16:
      nearest_codes_kernel<T, 16><<<grid, kTokens, 0, stream>>>(z, codes, part_d, part_i, n,
                                                                k, split);
      break;
    case 32:
      nearest_codes_kernel<T, 32><<<grid, kTokens, 0, stream>>>(z, codes, part_d, part_i, n,
                                                                k, split);
      break;
    case 64:
      nearest_codes_kernel<T, 64><<<grid, kTokens, 0, stream>>>(z, codes, part_d, part_i, n,
                                                                k, split);
      break;
    default:
      nearest_codes_any_kernel<T><<<grid, kTokens, 0, stream>>>(z, codes, part_d, part_i, n,
                                                                k, d, split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part_d, part_i, out, n,
                                                       slices);
  return cudaGetLastError();
}

}  // namespace

// part_d / part_i: scratch of n * ceil(k / split) entries each.
AMT_EXPORT int amt_nearest_codes(const void* z, const void* codes, void* part_d,
                                 void* part_i, void* out, int n, int k, int d,
                                 int split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  int* o = static_cast<int*>(out);
  if (n == 0) return cudaSuccess;
  if (k == 0 || split <= 0 || split % kCodes != 0) return cudaErrorInvalidValue;
  if (dtype == AMT_BF16)
    return launch(static_cast<const __nv_bfloat16*>(z),
                  static_cast<const __nv_bfloat16*>(codes), pd, pi, o, n, k, d,
                  split, s);
  if (dtype == AMT_F32)
    return launch(static_cast<const float*>(z), static_cast<const float*>(codes),
                  pd, pi, o, n, k, d, split, s);
  return cudaErrorInvalidValue;
}
