// Backward of the fused GELU MLP out = gelu(x W1^T + b1) W2^T + b2 (kernel 8;
// csrc/mlp.cu is its forward).
//
// Replaces attention_models_tpu/ops/ffn.py::_mlp_bwd_kernel (entry
// _mlp_bwd), bf16 as there. From x (n, d), W1 (hid, d), b1 (fp32), W2
// (d, hid) -- the torch Linear layout -- and the cotangent dy (n, d) it
// returns dx (n, d) and dW1 (hid, d), db1, dW2 (d, hid), db2 in fp32, with
// the TPU kernel's formulas and rounding points: h = x W1^T + b1 recomputed
// in fp32, g = bf16(gelu(h)), db2 = sum of dy, dW2 = dy^T g, dg = dy W2 in
// fp32, dh = dg (Phi(h) + h phi(h)), db1 = sum of the fp32 dh, then
// dx = bf16(dh) W1 and dW1 = bf16(dh)^T x. gelu uses the true erff.
//
// Bound on the H100: operations. Five products of 2 n d hid flops -- the
// recompute x W1^T, dy W2, dW2, dx and dW1 -- are 10 n d hid (PERF.md's
// convention for the ln_mlp backward): at ViT's n 4160, d 1024, hid 2048
// that is 87.2 GFLOP, 0.088 ms at the bf16 tensor-core peak; x, dy, dx,
// the weights and their fp32 gradients are ~43 MB (0.013 ms).
//
// Design. The TPU kernel walks row tiles in order and accumulates the four
// weight and bias gradients in resident fp32 outputs. Blocks run in
// parallel here and no SM holds a 16 MB fp32 partial, so the work is split
// into deterministic passes without atomics, as csrc/ffn_bwd.cu splits the
// GEGLU backward:
//   1. one tile kernel computes x W1^T and dy W2 over the same 128 x 128
//      (rows, hidden) tile -- two csrc/gemm.cuh products into two register
//      accumulators -- and its epilogue writes g and bf16(dh) to (n, hid)
//      scratches and the tile's column sums of the fp32 dh;
//   2. db2: per-64-row column sums of dy, then the partials in order;
//   3. db1: pass 1's per-tile partials in order;
//   4. dW2 = dy^T g, dx = bf16(dh) W1 and dW1 = bf16(dh)^T x, tile products
//      of csrc/gemm.cuh (the A^T B ones reduce over all n rows in order
//      inside each block).
// The scratch (g and dh, 34 MB in bf16 at ViT's shape) is the price of the
// deterministic split. csrc/ln_mlp_bwd.cu's wide path calls the same passes
// with an fp32 dx (its LN backward takes dy_ln unrounded).
#include "gemm.cuh"

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;
constexpr int kColRows = 64;  // rows per partial of the db2 column sums

// Pass 1. Block (bx, by) owns rows by*128.. and hidden columns bx*128..;
// dhpart is (gridDim.y, hid).
__global__ __launch_bounds__(kThreads) void mlp_bwd_h_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const bf16* __restrict__ dy, bf16* __restrict__ gout,
    bf16* __restrict__ dhout, float* __restrict__ dhpart, int n, int d, int hid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][kBN];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float hacc[4][4][4], gacc[4][4][4];
  mma_tile<kK, kK>(x, d, n, w1, d, hid, d, m0, n0, smem, hacc);   // x W1^T
  mma_tile<kK, kR>(dy, d, n, w2, hid, hid, d, m0, n0, smem, gacc);  // dy W2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int cl = wn * 32 + nt * 8 + 2 * t;  // column within the tile
    const int col = n0 + cl;
    const bool ok = col < hid;  // hid % 8 == 0: both columns or neither
    float csum[2] = {0.f, 0.f};
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
        float gv[2], dv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float h = hacc[mt][nt][2 * half + u] + (ok ? b1[col + u] : 0.f);
          const float phi = 0.5f * (1.f + erff(h * kInvSqrt2));
          const float pdf = expf(-0.5f * h * h) * kInvSqrt2Pi;
          gv[u] = h * phi;
          dv[u] = gacc[mt][nt][2 * half + u] * (phi + h * pdf);
          csum[u] += dv[u];  // rows past n have dy = 0, so dv = 0
        }
        if (ok && row < n) {
          const int64_t at = (int64_t)row * hid + col;
          store2(gout + at, gv[0], gv[1]);
          store2(dhout + at, dv[0], dv[1]);
        }
      }
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {
      csum[0] += __shfl_xor_sync(0xffffffffu, csum[0], o);
      csum[1] += __shfl_xor_sync(0xffffffffu, csum[1], o);
    }
    if (g == 0) {
      red[wm][cl] = csum[0];
      red[wm][cl + 1] = csum[1];
    }
  }
  __syncthreads();
  if (threadIdx.x < kBN && n0 + threadIdx.x < hid)
    dhpart[(int64_t)blockIdx.y * hid + n0 + threadIdx.x] =
        red[0][threadIdx.x] + red[1][threadIdx.x];
}

// part[y][c] = sum of a[r][c] over rows y*kColRows.. in order
__global__ void colsum_rows_bf16_kernel(const bf16* __restrict__ a, float* __restrict__ part,
                                        int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * kColRows, r1 = min(r0 + kColRows, rows);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += __bfloat162float(a[(int64_t)r * cols + c]);
  part[(int64_t)blockIdx.y * cols + c] = s;
}

}  // namespace

// The passes above; dx goes to dx16 (bf16) or, when that is null, to dx32.
// Scratch: g and dh (n, hid) bf16; dhpart (ceil(n / 128), hid) and dypart
// (ceil(n / 64), d) fp32.
cudaError_t amt_mlp_bwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                             const bf16* dy, bf16* gs, bf16* dhs, float* dhpart,
                             float* dypart, bf16* dx16, float* dx32, float* dw1, float* db1,
                             float* dw2, float* db2, int n, int d, int hid, cudaStream_t s) {
  if (n <= 0 || d % 8 != 0 || hid % 8 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n + kBM - 1) / kBM;
  mlp_bwd_h_kernel<<<dim3((hid + kBN - 1) / kBN, row_tiles), kThreads, kTileSmem, s>>>(
      x, w1, b1, w2, dy, gs, dhs, dhpart, n, d, hid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int dy_parts = (n + kColRows - 1) / kColRows;
  colsum_rows_bf16_kernel<<<dim3((d + 255) / 256, dy_parts), 256, 0, s>>>(dy, dypart, n, d);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = colsum(dypart, db2, dy_parts, d, s)) != cudaSuccess ||
      (err = colsum(dhpart, db1, row_tiles, hid, s)) != cudaSuccess ||
      (err = gemm_bf16<kR, kR, float>(dy, d, gs, hid, dw2, hid, d, hid, n, s)) !=
          cudaSuccess)
    return err;
  err = dx16 != nullptr
            ? gemm_bf16<kK, kR, bf16>(dhs, hid, w1, d, dx16, d, n, d, hid, s)
            : gemm_bf16<kK, kR, float>(dhs, hid, w1, d, dx32, d, n, d, hid, s);
  if (err != cudaSuccess) return err;
  return gemm_bf16<kR, kR, float>(dhs, hid, x, d, dw1, d, hid, d, n, s);
}

AMT_EXPORT int amt_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                           const void* dy, void* g_scratch, void* dh_scratch, void* dhpart,
                           void* dypart, void* dx, void* dw1, void* db1, void* dw2, void* db2,
                           int n, int d, int hid, void* stream) {
  return amt_mlp_bwd_bf16(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const bf16*>(dy), static_cast<bf16*>(g_scratch),
      static_cast<bf16*>(dh_scratch), static_cast<float*>(dhpart), static_cast<float*>(dypart),
      static_cast<bf16*>(dx), nullptr, static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2), n, d, hid,
      static_cast<cudaStream_t>(stream));
}
