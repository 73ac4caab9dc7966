// Fused GEGLU feed-forward: out = LN_gamma(gate * gelu(a)) W2^T with
// [a | gate] = x W1^T, no biases, gelu on the first half, a gamma-only
// LayerNorm (fp32 statistics, biased variance) over the inner width.
//
// Replaces attention_models_tpu/ops/ffn.py::_ffn_kernel (entry fused_ffn /
// _ffn_forward), bf16 and fp32. W1 is (2i, d) and W2 (d, i): the torch
// Linear layout, whose rows are the K-major B operand as they stand.
//
// Bound on the H100: operations. At the MaskGIT decode shape (n = 8192
// rows, d 768, i 4096) the two products are 6*n*d*i = 154.6 GFLOP: 0.156 ms
// at the bf16 tensor-core peak, 2.31 ms at the fp32 FMA peak; x, out and
// the weights are ~44 MB (0.013 ms).
//
// Design. The LayerNorm sits between the two products over the full inner
// width, so a row's W2 product cannot start before all of its g is known.
// The TPU kernel holds a row tile's whole g and both weight matrices in
// VMEM; here a 64-row fp32 g alone is 1 MB. So g goes through a global
// scratch, which keeps the TPU kernel's rounding points exactly (a, gate,
// g and its two-pass statistics in fp32, y = ghat * gamma rounded to the
// dtype before the W2 product), in three launches:
//   1. the GEGLU product. bf16: csrc/gemm_sm90.cuh's TMA/wgmma tile product
//      in its paired-column form (Paired): a block's B tile is two TMA
//      boxes of W1, BN/2 "a" rows and the BN/2 matching "gate" rows, so
//      accumulator columns j and j + BN/2 of a thread are a and gate of one
//      inner column, and the epilogue (GegluF32) writes g = gate * gelu(a)
//      (true erff; the TPU kernel's A&S polynomial differs by <= 1.5e-7) to
//      an fp32 scratch through the freed ring; W1 is read as it lies, x
//      once for every BN/2 inner columns. fp32: geglu_f32_kernel, the
//      register-tiled FMA product of csrc/gemm.cuh with the B tile's
//      columns 0-63 on W1's "a" rows and 64-127 on the matching "gate"
//      rows, which a thread's two column groups pair;
//   2. ffn_ln_rows_kernel: one block a row, the row read once into
//      registers (16-byte pieces; a row wider than kRowsMax in chunks read
//      again for each step), the two-pass fp32 mean and variance from them,
//      y = (g - mean) * rsqrt(var + eps) * gamma written once in the dtype
//      (64-byte aligned rows);
//   3. out = y W2^T: the tile product with the StoreBf16 epilogue (bf16),
//      csrc/gemm.cuh's FMA product with K split into ordered partials where
//      its last wave would run half empty (fp32).
// The host plan (ops/ffn.py::ffn_plan, 42 int64: the GEGLU product's and
// the W2 product's GemmPlans) holds the maps (W1's B boxes BN/2 rows), the
// tile widths, grids, shared memory and the scratches' row pitches. The
// scratch traffic, g (fp32) written and read once and y written and read
// once, is ~0.06 ms at n 8192 beside the products.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kLds = kLdK;  // shared row stride (bf16) of the A and B tiles

using sm90::gelu_exact;

// Kernel 20's bf16 up-projection (csrc/quant.cu's wide int8 FFN, through
// amt_geglu_bf16) is this kernel's only caller; kernel 11 runs the
// paired-column tile product below.
// H = x W1^T for bf16 x (M, K) and W1 (2 * inner, K), both row-major: tile
// column c of block column bx reads W1 row bx*64 + (c/16)*8 + c%8, plus
// inner when (c/8) is odd; the block writes g = gate * gelu(a) for inner
// columns bx*64 .. bx*64+63 to fp32 C (M, inner).
__global__ __launch_bounds__(kThreads) void gemm_geglu_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    float* __restrict__ c, int M, int K, int inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kBM][kLds]
  __nv_bfloat16* bs = as + kStages * kBM * kLds;                   // [kStages][kBN][kLds]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4;  // rows wm*64 .. +63 of the tile
  const int wn = warp % 4;  // columns wn*32 .. +31 of the tile
  const int m0 = blockIdx.y * kBM;

  // each thread copies two 16-byte pieces of A and two of B per stage
  const __nv_bfloat16* a_src[2];
  const __nv_bfloat16* b_src[2];
  bool a_ok[2];
  int s_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kThreads;
    const int r = id >> 2, kc = (id & 3) * 8;
    a_ok[i] = m0 + r < M;
    a_src[i] = a + (int64_t)(a_ok[i] ? m0 + r : 0) * K + kc;
    const int brow = blockIdx.x * 64 + (r >> 4) * 8 + (r & 7) + ((r >> 3) & 1) * inner;
    b_src[i] = b + (int64_t)brow * K + kc;
    s_off[i] = r * kLds + kc;
  }
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(as + stage * kBM * kLds + s_off[i], a_src[i] + k0, a_ok[i]);
      cp_async16(bs + stage * kBN * kLds + s_off[i], b_src[i] + k0, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed for this thread
    __syncthreads();               // ... for every thread; slice kt-1 is done
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBK);
    cp_async_commit();
    const __nv_bfloat16* at = as + (kt % kStages) * kBM * kLds;
    const __nv_bfloat16* bt = bs + (kt % kStages) * kBN * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* p = at + (wm * 64 + mt * 16 + g) * kLds + kk + 2 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = bt + (wn * 32 + nt * 8 + g) * kLds + kk + 2 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
      // tiles nt = 0, 1 (and 2, 3) hold a and gate of the same 8 columns
      float* out = c + (int64_t)row * inner;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = blockIdx.x * 64 + (wn * 2 + p) * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + col) = make_float2(
            acc[mt][2 * p + 1][2 * half] * gelu_exact(acc[mt][2 * p][2 * half]),
            acc[mt][2 * p + 1][2 * half + 1] * gelu_exact(acc[mt][2 * p][2 * half + 1]));
      }
    }
  }
}

// The GEGLU product's epilogue (bf16, paired columns): acc[4i + e] and
// acc[4(i + BN/16) + e] are a and gate of inner column n0/2 + 8i + 2t +
// (e % 2); g = gate * gelu(a) in fp32 through the warpgroup's padded
// staging rows, then 16-byte row pieces below M and inner.
struct GegluF32 {
  struct Args {
    float* g;  // (M, inner) fp32, rows ldg elements apart
    int m, inner, ldg;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = sm90::Staged<BN / 2, float>;
    constexpr int kHalf = BN / 16;  // the gate's acc index offset, / 4
    uint8_t* st = ring + c * S::kBytes;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = acc[4 * (i + kHalf) + e] * gelu_exact(acc[4 * i + e]);
      S::put(st, rl, 8 * i + 2 * t, v[0], v[1]);
      S::put(st, rl + 8, 8 * i + 2 * t, v[2], v[3]);
    }
    hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.g, a.ldg, m0r, n0 / 2, a.m, a.inner);
  }
};

// fp32 GEGLU product: g (M, inner; rows ldg apart) = gate * gelu(a) of
// x W1^T, one 128 x 64 block of g a block: tile columns 0-63 read W1 rows
// c0 .. c0 + 63 ("a"), 64-127 rows inner + c0 .. ("gate"), so a thread's
// accumulators j and j + 4 are a and gate of g column c0 + 4 tx + j.
__global__ __launch_bounds__(kRThreads, 2) void geglu_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    float* __restrict__ g, int ldg, int M, int K, int inner) {
  __shared__ __align__(16) RTiles<128> sm;
  const int m0 = blockIdx.y * kRM, c0 = blockIdx.x * 64;
  const int tr = Piece<kK, 128>::tile_row(threadIdx.x);
  const int brow = c0 + tr + (tr < 64 ? 0 : inner - 64);
  float acc[8][8];
  reg_product<128>(plain_piece<kK, kRM>(x, K, M, m0),
                   Piece<kK, 128>(w1, K, brow, true, threadIdx.x), K, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (row < M)
      store4(g + (int64_t)row * ldg + c0 + 4 * tx,
             acc[i][4] * gelu_exact(acc[i][0]), acc[i][5] * gelu_exact(acc[i][1]),
             acc[i][6] * gelu_exact(acc[i][2]), acc[i][7] * gelu_exact(acc[i][3]));
  }
}

// y = (g - mean) * rsqrt(var + eps) * gamma for one row of the fp32 scratch
// g a block (row_threads(min(inner, kRowsMax), NV) threads): the mean, then
// the variance over (g - mean), each a fixed-order block sum. A row of at
// most blockDim.x * NV 16-byte pieces is read once and held in registers; a
// wider one is walked in chunks of that many pieces, each of the three
// steps reading its chunks again (4 inner bytes a row, from L2).
template <typename T, int NV>
__global__ __launch_bounds__(256) void ffn_ln_rows_kernel(
    const float* __restrict__ g, int ldg, const float* __restrict__ gamma,
    T* __restrict__ y, int ldy, int inner, float eps) {
  __shared__ float red[32];
  const int n4 = inner / 4, nt = blockDim.x, step = nt * NV;
  // NV 4 serves rows of at most kRowsNV4 columns only, which it holds
  const bool held = NV == 4 || n4 <= step;
  const int chunks = held ? 1 : (n4 + step - 1) / step;
  const float4* gr = reinterpret_cast<const float4*>(g + (int64_t)blockIdx.x * ldg);
  float4 v[NV];
  const auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + threadIdx.x + nt * u;
      v[u] = c < n4 ? gr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float s[1] = {0.f};
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * step;
    load(c0);
#pragma unroll
    for (int u = 0; u < NV; ++u) s[0] += (v[u].x + v[u].y) + (v[u].z + v[u].w);
  }
  block_sums(s, red);
  const float mean = s[0] / inner;
  float q[1] = {0.f};
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * step;
    if (!held) load(c0);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      if (c0 + threadIdx.x + nt * u >= n4) continue;
      const float d0 = v[u].x - mean, d1 = v[u].y - mean;
      const float d2 = v[u].z - mean, d3 = v[u].w - mean;
      q[0] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  block_sums(q, red);
  const float rstd = rsqrtf(q[0] / inner + eps);
  T* out = y + (int64_t)blockIdx.x * ldy;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * step;
    if (!held) load(c0);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + threadIdx.x + nt * u;
      if (c >= n4) continue;
      const float4 gm = reinterpret_cast<const float4*>(gamma)[c];
      store4(out + 4 * c, (v[u].x - mean) * rstd * gm.x, (v[u].y - mean) * rstd * gm.y,
             (v[u].z - mean) * rstd * gm.z, (v[u].w - mean) * rstd * gm.w);
    }
  }
}

template <typename T>
cudaError_t ln_rows(const float* g, int ldg, const float* gamma, T* y, int ldy, int n,
                    int inner, float eps, cudaStream_t s) {
  if (inner <= kRowsNV4)
    ffn_ln_rows_kernel<T, 4><<<n, row_threads(inner, 4), 0, s>>>(g, ldg, gamma, y, ldy,
                                                               inner, eps);
  else
    ffn_ln_rows_kernel<T, 8><<<n, row_threads(min(inner, kRowsMax), 8), 0, s>>>(
        g, ldg, gamma, y, ldy, inner, eps);
  return cudaGetLastError();
}

}  // namespace

// The first launch of kernel 20's bf16 wide FFN (csrc/quant.cu): g = gate *
// gelu(a) of x W1^T into fp32 g (n, inner), on the mma.sync kernel above.
cudaError_t amt_geglu_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1, float* g,
                           int n, int d, int inner, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_geglu_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
  if (err != cudaSuccess) return err;
  gemm_geglu_bf16_kernel<<<dim3(inner / 64, (n + kBM - 1) / kBM), kThreads, kTileSmem, s>>>(
      x, w1, g, n, d, inner);
  return cudaGetLastError();
}

// plan: ops/ffn.py::FfnPlan (bf16: the GEGLU and W2 products, 42 int64; fp32
// takes none). g_scratch: fp32 (n, inner) and y_scratch: (n, inner) in the
// dtype, at the plan's row pitches (bf16) or inner elements a row (fp32);
// part (fp32 only): 2 n d floats for the W2 product's split partials.
AMT_EXPORT int amt_ffn(const int64_t* plan, const void* x, const void* w1,
                       const void* gamma, const void* w2, void* g_scratch,
                       void* y_scratch, void* part, void* out, int n, int d, int inner,
                       float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (n < 0 || d % 128 != 0 || inner % 128 != 0)
    return cudaErrorInvalidValue;
  const auto* gm = static_cast<const float*>(gamma);
  float* gs = static_cast<float*>(g_scratch);
  cudaError_t err;
  if (dtype == AMT_BF16) {
    constexpr int P = sm90::kPlanValues;
    if (plan == nullptr) return cudaErrorInvalidValue;
    const int ldg = (int)plan[19];         // g's pitch (fp32 elements)
    const int ldy = (int)(plan[P + 2] / 2);  // y's: the W2 product's A map
    auto* ys = static_cast<bf16*>(y_scratch);
    const GegluF32::Args ga{gs, n, inner, ldg};
    if ((err = sm90::gemm_from_plan<sm90::Paired, GegluF32, 256>(
             plan, nullptr, x, w1, nullptr, nullptr, ga, n, 2 * inner, d, ldg, s)) !=
            cudaSuccess ||
        (err = ln_rows<bf16>(gs, ldg, gm, ys, ldy, n, inner, eps, s)) != cudaSuccess)
      return err;
    const sm90::StoreBf16::Args oa{static_cast<bf16*>(out), n, d, d, 0};
    return sm90::gemm_from_plan<sm90::Form<sm90::kK, sm90::kK>, sm90::StoreBf16, 128, 256>(
        plan + P, nullptr, ys, w2, nullptr, nullptr, oa, n, d, inner, d, s);
  }
  if (dtype == AMT_F32) {
    auto* ys = static_cast<float*>(y_scratch);
    geglu_f32_kernel<<<dim3(inner / 64, (n + kRM - 1) / kRM), kRThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), gs, inner, n, d,
        inner);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = ln_rows<float>(gs, inner, gm, ys, inner, n, inner, eps, s)) != cudaSuccess)
      return err;
    return gemm_f32_split<kK, kK>(ys, inner, static_cast<const float*>(w2), inner,
                                  static_cast<float*>(out), d, n, d, inner,
                                  static_cast<float*>(part), 2 * (int64_t)n * d, s);
  }
  return cudaErrorInvalidValue;
}
