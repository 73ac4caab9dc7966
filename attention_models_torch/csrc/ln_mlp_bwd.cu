// Backward of the fused pre-LN MLP block out = x + gelu(LN(x) W1^T + b1) W2^T + b2.
//
// Replaces attention_models_tpu/ops/ffn.py::_ln_mlp_bwd_kernel (entry
// _ln_mlp_bwd), bf16 as there. From x, the LN affine, W1 (hid, d), b1,
// W2 (d, hid) and the cotangent dy it recomputes LN -> W1 -> gelu and
// produces dx (with the residual and the LN backward) in bf16 and dlng,
// dlnb, dW1, db1, dW2, db2 in fp32. gelu uses the true erff (the TPU kernel
// used the A&S 7.1.26 polynomial, at most 1.5e-7 away).
//
// Bound on the H100: operations. Its five products (the H recompute, dG,
// dW2, dW1, dy_ln) are 10*n*d*hid flops: at the main path's n 8192, d 512,
// hid 1368 that is 58 us at the bf16 tensor-core peak, against ~33 MB of
// inputs and outputs (10 us).
//
// The TPU kernel adds the weight gradients over a sequential grid into
// resident outputs. On the H100 blocks run in parallel, and one fp32 partial
// of dW1 + dW2 (5.6 MB) per block would not fit, so the work is split in two
// deterministic passes (no atomics):
//   1. rows: a block of 8 warps takes 32 rows. It normalises them into
//      shared memory (fp32 statistics; yc rounded to bf16 as the forward
//      does, and written out), keeps the dy tile, and walks hid in chunks of
//      64: H = yc W1c^T + b1 and dG = dy W2c are two mma.sync products,
//      G = gelu(H) and dH = dG * gelu'(H) go to device memory in bf16 (the
//      TPU kernel's own roundings), and dy_ln += dH W1c accumulates in fp32
//      registers. The epilogue forms dx = dy + rstd (dxhat - mean(dxhat)
//      - xhat mean(dxhat xhat)) and this block's partial column sums of
//      dy_ln * xhat and dy_ln. hid 1368 is not a multiple of 64: the last
//      chunk's missing W1 rows and W2 columns are zero-filled by cp.async,
//      so they give dG = 0 and dH = 0 and add nothing.
//      Each 16-row group also writes its column sums of the fp32 dH (before
//      the bf16 rounding, as the TPU kernel sums db1).
//   2. weights: dW1 = dH^T yc and dW2 = dy^T G are A^T B products whose
//      blocks each own a 64 x 64 tile of the output and reduce over all n
//      rows in order; the same blocks sum db2 (over dy). A small kernel
//      sums pass 1's partials, in order, into dlng, dlnb and db1.
// mma.sync in place of wgmma and the untuned tiling are what later PRs
// improve; the scratch (yc, G, dH: 52 MB at the main path) is the price of
// a deterministic reduction.
//
// Widths. Pass 1 is instantiated for d 128, 256, 384 and 512 (its shared
// memory, 213 KB at d 512, grows with d). Every wider d % 128 == 0 runs the
// forward's LayerNorm into the yc scratch, kernel 8's passes
// (csrc/mlp_bwd.cu) on yc with dy_ln = dH W1 kept in fp32, then a row pass
// of the LN backward (ln_bwd_rows_kernel) with the same formulas as pass 1's
// epilogue and the same per-block partials of dlng and dlnb.
#include "gemm.cuh"

extern "C" int amt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int64_t n, int d, float eps, int dtype, void* stream);
cudaError_t amt_mlp_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                             const float* b1, const __nv_bfloat16* w2,
                             const __nv_bfloat16* dy, __nv_bfloat16* gs, __nv_bfloat16* dhs,
                             float* dhpart, float* dypart, __nv_bfloat16* dx16, float* dx32,
                             float* dw1, float* db1, float* dw2, float* db2, int n, int d,
                             int hid, cudaStream_t s);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 32;   // rows per block of pass 1 (ops/ffn.py BWD_ROWS)
constexpr int kChunk = 64;  // hidden columns per step
constexpr int kCS = kChunk + 8;
constexpr int kTK = 32;     // pass 2: rows per step
constexpr int kTS = 64 + 8; // pass 2: smem row stride
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

template <int D>
constexpr size_t rows_smem_bytes() {
  return sizeof(bf16) * ((size_t)2 * kRows * (D + 8) + (size_t)kChunk * (D + 8) +
                         (size_t)D * kCS + (size_t)kRows * kCS) +
         sizeof(float) * (2 * kRows + 2 * 4 * kRows);
}

template <int D>
__global__ __launch_bounds__(256, 1) void ln_mlp_bwd_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ lnb, const bf16* __restrict__ w1,
    const float* __restrict__ b1, const bf16* __restrict__ w2,
    const bf16* __restrict__ dy, bf16* __restrict__ dx, bf16* __restrict__ yc,
    bf16* __restrict__ gout, bf16* __restrict__ dhout,
    float* __restrict__ part, float* __restrict__ dhpart, int n, int hid,
    float eps) {
  constexpr int kYS = D + 8;
  constexpr int NT = D / 32;  // 8-wide dy_ln tiles per warp (D/4 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ys = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kYS]
  bf16* dos = ys + kRows * kYS;                   // [kRows][kYS]
  bf16* w1s = dos + kRows * kYS;                  // [kChunk][kYS]
  bf16* w2s = w1s + kChunk * kYS;                 // [D][kCS]
  bf16* dhs = w2s + D * kCS;                      // [kRows][kCS]
  float* mean_s = reinterpret_cast<float*>(dhs + kRows * kCS);
  float* rstd_s = mean_s + kRows;
  float* red = rstd_s + kRows;                    // [2][4][kRows]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp & 1;   // 16-row group
  const int wc = warp >> 1;  // quarter of the columns
  const int row0 = blockIdx.x * kRows;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the dy tile (rows past n zero-filled)
  for (int i = threadIdx.x; i < kRows * (D / 8); i += blockDim.x) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dos + r * kYS + c, dy + (ok ? (int64_t)(row0 + r) * D + c : 0), ok);
  }
  cp_async_commit();

  // LN: each warp normalises 4 rows, 8 bf16 per lane per 16-byte load (at D
  // 128 and 384 the last load slot of some lanes lies past the row)
  constexpr int VPL = (D / 8 + 31) / 32;
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const int r = warp * (kRows / 8) + rr;
    const int gr = row0 + r;
    float v[VPL][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int col = (lane + c * 32) * 8;
      const uint4 raw = gr < n && col < D
                            ? *reinterpret_cast<const uint4*>(x + (int64_t)gr * D + col)
                            : zero;
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[c][j] = __bfloat162float(e[j]);
        sum += v[c][j];
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
      if ((lane + c * 32) * 8 < D)
#pragma unroll
        for (int j = 0; j < 8; ++j) sq += (v[c][j] - mean) * (v[c][j] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int col = (lane + c * 32) * 8;
      if (col >= D) continue;
      uint4 packed;
      uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = col + 2 * j;
        p[j] = pack_bf16x2((v[c][2 * j] - mean) * rstd * lng[c0] + lnb[c0],
                           (v[c][2 * j + 1] - mean) * rstd * lng[c0 + 1] + lnb[c0 + 1]);
      }
      *reinterpret_cast<uint4*>(ys + r * kYS + col) = packed;
      if (gr < n) *reinterpret_cast<uint4*>(yc + (int64_t)gr * D + col) = packed;
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int nchunks = (hid + kChunk - 1) / kChunk;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int h0 = ch * kChunk;
    __syncthreads();  // no warp reads the previous chunk's slices any more
    for (int i = threadIdx.x; i < kChunk * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = h0 + r < hid;
      cp_async16(w1s + r * kYS + c, w1 + (ok ? (int64_t)(h0 + r) * D + c : 0), ok);
    }
    for (int i = threadIdx.x; i < D * (kChunk / 8); i += blockDim.x) {
      const int o = i / (kChunk / 8), c = (i % (kChunk / 8)) * 8;
      const bool ok = h0 + c < hid;
      cp_async16(w2s + o * kCS + c, w2 + (ok ? (int64_t)o * hid + h0 + c : 0), ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // H = yc W1c^T and dG = dy W2c: 16 rows x 16 hidden columns per warp
    float hacc[2][4], gacc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] = gacc[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ay[4], ad[4];
      load_a_frag(ay, ys + (wr * 16) * kYS + kk * 16, kYS, 1);
      load_a_frag(ad, dos + (wr * 16) * kYS + kk * 16, kYS, 1);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t b[2];
        load_b_frag(b, w1s + (wc * 16 + nt * 8) * kYS + kk * 16, 1, kYS);
        mma_bf16_16816(hacc[nt], ay, b);
        load_b_frag(b, w2s + (kk * 16) * kCS + wc * 16 + nt * 8, kCS, 1);
        mma_bf16_16816(gacc[nt], ad, b);
      }
    }
    // G = gelu(H), dH = dG * gelu'(H): bf16 to device memory and dH to
    // smem; the fp32 dH (before its rounding) summed over the warp's 16 rows
    // into this row group's partial of db1
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = wc * 16 + nt * 8 + 2 * t;
      const int hj = h0 + j;
      const bool ok = hj < hid;  // hid % 8 == 0: both columns or neither
      float dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr * 16 + g + half * 8;
        const int gr = row0 + r;
        float gv[2], dv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float hv = hacc[nt][2 * half + u] + (ok ? b1[hj + u] : 0.f);
          const float phi = 0.5f * (1.f + erff(hv * kInvSqrt2));
          const float pdf = expf(-0.5f * hv * hv) * kInvSqrt2Pi;
          gv[u] = hv * phi;
          dv[u] = gacc[nt][2 * half + u] * (phi + hv * pdf);
          dsum[u] += dv[u];  // rows past n have dy = 0, so dv = 0
        }
        const uint32_t dpk = ok ? pack_bf16x2(dv[0], dv[1]) : 0u;
        *reinterpret_cast<uint32_t*>(dhs + r * kCS + j) = dpk;
        if (ok && gr < n) {
          const int64_t at = (int64_t)gr * hid + hj;
          *reinterpret_cast<uint32_t*>(gout + at) = pack_bf16x2(gv[0], gv[1]);
          *reinterpret_cast<uint32_t*>(dhout + at) = dpk;
        }
      }
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {
        dsum[0] += __shfl_xor_sync(0xffffffffu, dsum[0], o);
        dsum[1] += __shfl_xor_sync(0xffffffffu, dsum[1], o);
      }
      // dhpart is (2 * gridDim.x, hid): one row per 16-row group
      if (g == 0 && ok)
        *reinterpret_cast<float2*>(
            dhpart + (int64_t)(blockIdx.x * 2 + wr) * hid + hj) =
            make_float2(dsum[0], dsum[1]);
    }
    __syncthreads();  // dH of the chunk is in shared memory

    // dy_ln (16 rows x D/4 columns per warp) += dH W1c
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, dhs + (wr * 16) * kCS + kk * 16, kCS, 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        load_b_frag(b, w1s + (kk * 16) * kYS + wc * (D / 4) + nt * 8, kYS, 1);
        mma_bf16_16816(acc[nt], a, b);
      }
    }
  }
  __syncthreads();  // the weight slices are free: w2s becomes fp32 scratch

  // the LN backward: xhat, row means of dxhat and dxhat * xhat
  float* colred = reinterpret_cast<float*>(w2s);  // [2 wr][2 kinds][D]
  float xh[NT][4];
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wc * (D / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr * 16 + g + half * 8;
      const int gr = row0 + r;
      float xv0 = 0.f, xv1 = 0.f;
      if (gr < n) {
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + (int64_t)gr * D + col);
        xv0 = __bfloat162float(xv.x);
        xv1 = __bfloat162float(xv.y);
      }
      const float mean = mean_s[r], rstd = rstd_s[r];
      xh[nt][2 * half] = (xv0 - mean) * rstd;
      xh[nt][2 * half + 1] = (xv1 - mean) * rstd;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float dxh = acc[nt][2 * half + u] * lng[col + u];
        s1[half] += dxh;
        s2[half] += dxh * xh[nt][2 * half + u];
      }
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr * 16 + g + half * 8;
      red[(0 * 4 + wc) * kRows + r] = s1[half];
      red[(1 * 4 + wc) * kRows + r] = s2[half];
    }
  }
  // this warp's column sums over its 16 rows of dy_ln * xhat and dy_ln
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wc * (D / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float cg = acc[nt][u] * xh[nt][u] + acc[nt][2 + u] * xh[nt][2 + u];
      float cb = acc[nt][u] + acc[nt][2 + u];
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {
        cg += __shfl_xor_sync(0xffffffffu, cg, o);
        cb += __shfl_xor_sync(0xffffffffu, cb, o);
      }
      if (g == 0) {
        colred[(wr * 2 + 0) * D + col + u] = cg;
        colred[(wr * 2 + 1) * D + col + u] = cb;
      }
    }
  }
  __syncthreads();

  // dx = dy + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr * 16 + g + half * 8;
    const int gr = row0 + r;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m1 += red[(0 * 4 + q) * kRows + r];
      m2 += red[(1 * 4 + q) * kRows + r];
    }
    m1 /= D;
    m2 /= D;
    const float rstd = rstd_s[r];
    if (gr < n) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = wc * (D / 4) + nt * 8 + 2 * t;
        float o[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float dxh = acc[nt][2 * half + u] * lng[col + u];
          o[u] = __bfloat162float(dos[r * kYS + col + u]) +
                 rstd * (dxh - m1 - xh[nt][2 * half + u] * m2);
        }
        *reinterpret_cast<uint32_t*>(dx + (int64_t)gr * D + col) =
            pack_bf16x2(o[0], o[1]);
      }
    }
  }
  // this block's partial dlng / dlnb: part is (2, gridDim.x, D)
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      part[((int64_t)k * gridDim.x + blockIdx.x) * D + c] =
          colred[(0 * 2 + k) * D + c] + colred[(1 * 2 + k) * D + c];
  }
}

// C (M x N, fp32) = A^T B for A (rows x M) and B (rows x N) in bf16, M and N
// multiples of 8. A block owns a 64 x 64 tile of C and reduces over all rows
// in order; the blocks of the first column of tiles also write the column
// sums of A (colsum may be null).
__global__ __launch_bounds__(128) void atb_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B,
    float* __restrict__ C, float* __restrict__ colsum, int rows, int M,
    int N) {
  __shared__ __align__(16) bf16 as[kTK][kTS];
  __shared__ __align__(16) bf16 bs[kTK][kTS];
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool do_sum = colsum != nullptr && blockIdx.x == 0;

  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float csum = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kTK) {
    __syncthreads();  // the previous step's readers are done
    for (int i = threadIdx.x; i < kTK * 8; i += blockDim.x) {
      const int r = i / 8, c = (i % 8) * 8;
      const bool okr = r0 + r < rows;
      const bool oka = okr && m0 + c < M, okb = okr && n0 + c < N;
      cp_async16(&as[r][c], A + (oka ? (int64_t)(r0 + r) * M + m0 + c : 0), oka);
      cp_async16(&bs[r][c], B + (okb ? (int64_t)(r0 + r) * N + n0 + c : 0), okb);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk) {
      uint32_t a[4];
      load_a_frag(a, &as[kk * 16][warp * 16], 1, kTS);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b[2];
        load_b_frag(b, &bs[kk * 16][nt * 8], kTS, 1);
        mma_bf16_16816(acc[nt], a, b);
      }
    }
    if (do_sum && threadIdx.x < 64)
      for (int r = 0; r < kTK; ++r) csum += __bfloat162float(as[r][threadIdx.x]);
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int nn = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp * 16 + g + half * 8;
      if (m < M && nn < N)
        *reinterpret_cast<float2*>(C + (int64_t)m * N + nn) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
  if (do_sum && threadIdx.x < 64 && m0 + threadIdx.x < M)
    colsum[m0 + threadIdx.x] = csum;
}

cudaError_t atb(const bf16* A, const bf16* B, float* C, float* colsum,
                int rows, int M, int N, cudaStream_t s) {
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  atb_bf16_kernel<<<grid, 128, 0, s>>>(A, B, C, colsum, rows, M, N);
  return cudaGetLastError();
}

// Passes 1 and 2 at a width the single pass takes.
template <int D>
cudaError_t fused_bwd(const bf16* x, const float* lng, const float* lnb, const bf16* w1,
                      const float* b1, const bf16* w2, const bf16* dy, bf16* dx, bf16* yc,
                      bf16* g, bf16* dh, float* part, float* dhpart, float* dlng,
                      float* dlnb, float* dw1, float* db1, float* dw2, float* db2, int n,
                      int hid, float eps, cudaStream_t s) {
  constexpr size_t bytes = rows_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  ln_mlp_bwd_rows_kernel<D><<<blocks, 256, bytes, s>>>(
      x, lng, lnb, w1, b1, w2, dy, dx, yc, g, dh, part, dhpart, n, hid, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // dlng, dlnb and db1 (over the fp32 dH, as the TPU kernel sums it)
  if ((err = colsum(part, dlng, blocks, D, s)) != cudaSuccess ||
      (err = colsum(part + (int64_t)blocks * D, dlnb, blocks, D, s)) !=
          cudaSuccess ||
      (err = colsum(dhpart, db1, 2 * blocks, hid, s)) != cudaSuccess)
    return err;
  // dW1 (hid, d) = dH^T yc; dW2 (d, hid) = dy^T G with db2 = colsum(dy)
  if ((err = atb(dh, yc, dw1, nullptr, n, hid, D, s)) != cudaSuccess) return err;
  return atb(dy, g, dw2, db2, n, D, hid, s);
}

// The wide path's LN backward: a block of 256 threads walks kRows rows; per
// row the two-pass fp32 statistics of x, then dx = dy + rstd (dxhat -
// mean(dxhat) - xhat mean(dxhat xhat)) with dxhat = dy_ln * lng. Thread j
// owns columns j, j + 256, ...: its running sums of dy_ln * xhat and dy_ln
// over the block's rows sit in shared memory and end in part (2,
// gridDim.x, d), pass 1's layout.
__global__ __launch_bounds__(kThreads) void ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ dyln, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, float* __restrict__ part, int n, int d, float eps) {
  extern __shared__ float cols[];  // [2][d]
  __shared__ float red[kThreads / 32];
  for (int c = threadIdx.x; c < 2 * d; c += kThreads) cols[c] = 0.f;
  __syncthreads();
  const int row0 = blockIdx.x * kRows, rend = min(row0 + kRows, n);
  for (int r = row0; r < rend; ++r) {
    const bf16* xr = x + (int64_t)r * d;
    const float* gr = dyln + (int64_t)r * d;
    float s = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) s += __bfloat162float(xr[c]);
    const float mean = block_sum(s, red) / d;
    float q = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float v = __bfloat162float(xr[c]) - mean;
      q += v * v;
    }
    const float rstd = rsqrtf(block_sum(q, red) / d + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xh = (__bfloat162float(xr[c]) - mean) * rstd;
      const float dxh = gr[c] * lng[c];
      s1 += dxh;
      s2 += dxh * xh;
      cols[c] += gr[c] * xh;
      cols[d + c] += gr[c];
    }
    const float m1 = block_sum(s1, red) / d;
    const float m2 = block_sum(s2, red) / d;
    for (int c = threadIdx.x; c < d; c += kThreads) {
      const float xh = (__bfloat162float(xr[c]) - mean) * rstd;
      const float dxh = gr[c] * lng[c];
      dx[(int64_t)r * d + c] = __float2bfloat16(
          __bfloat162float(dy[(int64_t)r * d + c]) + rstd * (dxh - m1 - xh * m2));
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads) {
    part[(int64_t)blockIdx.x * d + c] = cols[c];
    part[((int64_t)gridDim.x + blockIdx.x) * d + c] = cols[d + c];
  }
}

}  // namespace

// dyln (n, d) fp32 and dypart (ceil(n / 64), d) fp32: scratch used (and
// needed) only above d 512, where dhpart holds ceil(n / 128) rows of it.
AMT_EXPORT int amt_ln_mlp_bwd(const void* x, const void* lng, const void* lnb,
                              const void* w1, const void* b1, const void* w2,
                              const void* dy, void* dx, void* yc, void* g,
                              void* dh, void* part, void* dhpart, void* dyln,
                              void* dypart, void* dlng, void* dlnb, void* dw1,
                              void* db1, void* dw2, void* db2, int n, int d,
                              int hid, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || hid % 8 != 0 || d % 128 != 0) return cudaErrorInvalidValue;
  const auto* xi = static_cast<const bf16*>(x);
  const auto* gi = static_cast<const float*>(lng);
  const auto* bi = static_cast<const float*>(lnb);
  const auto* w1i = static_cast<const bf16*>(w1);
  const auto* b1i = static_cast<const float*>(b1);
  const auto* w2i = static_cast<const bf16*>(w2);
  const auto* dyi = static_cast<const bf16*>(dy);
  auto* dxo = static_cast<bf16*>(dx);
  auto* yci = static_cast<bf16*>(yc);
  auto* gs = static_cast<bf16*>(g);
  auto* dhs = static_cast<bf16*>(dh);
  auto* parti = static_cast<float*>(part);
  auto* dhparti = static_cast<float*>(dhpart);
  auto* dlngo = static_cast<float*>(dlng);
  auto* dlnbo = static_cast<float*>(dlnb);
  auto* dw1o = static_cast<float*>(dw1);
  auto* db1o = static_cast<float*>(db1);
  auto* dw2o = static_cast<float*>(dw2);
  auto* db2o = static_cast<float*>(db2);
#define AMT_FUSED_BWD(D)                                                                 \
  case D:                                                                                \
    return fused_bwd<D>(xi, gi, bi, w1i, b1i, w2i, dyi, dxo, yci, gs, dhs, parti, dhparti, \
                        dlngo, dlnbo, dw1o, db1o, dw2o, db2o, n, hid, eps, s);
  switch (d) {
    AMT_FUSED_BWD(128)
    AMT_FUSED_BWD(256)
    AMT_FUSED_BWD(384)
    AMT_FUSED_BWD(512)
  }
#undef AMT_FUSED_BWD
  auto* dyl = static_cast<float*>(dyln);
  auto* dyp = static_cast<float*>(dypart);
  if (dyl == nullptr || dyp == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = static_cast<cudaError_t>(
      amt_layernorm(x, lng, lnb, yc, n, d, eps, AMT_BF16, stream));
  if (err != cudaSuccess) return err;
  if ((err = amt_mlp_bwd_bf16(yci, w1i, b1i, w2i, dyi, gs, dhs, dhparti, dyp, nullptr, dyl,
                              dw1o, db1o, dw2o, db2o, n, d, hid, s)) != cudaSuccess)
    return err;
  const int blocks = (n + kRows - 1) / kRows;
  const size_t bytes = sizeof(float) * 2 * (size_t)d;
  if ((err = cudaFuncSetAttribute(ln_bwd_rows_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes)) != cudaSuccess)
    return err;
  ln_bwd_rows_kernel<<<blocks, kThreads, bytes, s>>>(xi, gi, dyl, dyi, dxo, parti, n, d, eps);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = colsum(parti, dlngo, blocks, d, s)) != cudaSuccess)
    return err;
  return colsum(parti + (int64_t)blocks * d, dlnbo, blocks, d, s);
}
