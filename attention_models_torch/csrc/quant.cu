// W8A8 int8 inference blocks: the GEGLU FFN with both products in int8
// (kernel 19), the wide-only GEGLU FFN (kernel 20: the up-projection in the
// activations' dtype, the down-projection in int8) and the int8 pre-LN MLP
// block (kernel 21).
//
// Replace attention_models_tpu/ops/quant.py::_ffn_q8_kernel (entry
// fused_ffn_q8), ::_ffn_q8wide_kernel (fused_ffn_q8wide) and
// ::_ln_mlp_q8_kernel (fused_ln_mlp_q8); x in bf16 or fp32. Quantized
// weights come in the torch Linear layout (d_out, d_in) int8 with fp32
// per-output-channel scales (ops/quant.py::quantize_weight): each row is
// K-contiguous, wgmma's K-major B as it stands.
//
// Bound on the H100: operations. At Muse's decode shape (n = 16384 rows,
// d 1024, inner 4096) kernel 19's two products are 6*n*d*i = 412 G int8
// operations: 0.208 ms at the int8 tensor-core peak (1979 TOPS), its
// up-projection 0.139 of it; kernel 20's bf16 up-projection alone is 0.278
// ms. Kernel 21 at the tokenizer's shape (n 8192, d 512, hid 1368) is
// 4*n*d*hid = 23 G: 0.0116 ms; its scratches (x read twice, y_q, g in fp32
// written and read, g_q written and read, the output) move about 146 MB,
// a floor near 0.044 ms at 3.35 TB/s.
//
// Design. Every activation scale is the amax of a whole row (d for x, inner
// for the FFN's y, hid for kernel 21's gelu output), and it must exist
// before the product that reads the codes starts; the FFN's LayerNorm also
// spans the whole inner row. So each block runs as row passes and tile
// products through global scratches, as csrc/ffn.cu does. Every product is
// csrc/gemm_sm90.cuh's TMA/wgmma tile product in its int8 form (x_q, y_q
// or g_q and the int8 weight K-major, boxes of 128 int8 of K, wgmma
// m64nBNk32 .s32.s8.s8, exact s32 sums) or, for kernel 20's up-projection,
// in bf16 / on the fp64 tensor cores. The host plans (ops/quant.py::
// q8_plan, q8wide_plan and ln_mlp_q8_plan: a GemmPlan of the up-projection
// and one of the down-projection) fix each map, grid and tile width and
// the scratches' pitches:
//   row_quant:  one block a row: optionally the LayerNorm (float64 sums of
//               the row and of its centred squares, rounded once to fp32),
//               then amax, the scale and the int8 codes (round half to even,
//               IEEE division, clip +-127). A row of up to 4096 values is
//               held in registers; a wider one is walked in chunks of 4096,
//               read again for each step, in the same order. Rows of at
//               most 1024 values with the LayerNorm (ln_codes_kernel, the
//               same float64 order) and of at most 1024 codes without it
//               (2048 of fp32: kernel 21's g; row_codes_kernel) take a
//               warp a row;
//   kernels 19 (four launches) and 20 (three):
//     - kernel 19 only: row_quant of x into x_q at the plan's pitch;
//     - the up-projection g = gate * gelu(a) of [a | gate] = x W1^T into an
//       fp32 scratch at the plan's row pitch, on the tile product's
//       paired-column form (W1's "a" and "gate" rows as two K-major half
//       boxes of one tile, so a thread holds a and gate of the same column):
//         kernel 19: PairedS8 (x_q and W1q int8) with the GegluDequant
//           epilogue, which dequantises a and gate, then writes g; one body
//           for bf16 and fp32 x (only the row pass of x and the output's
//           store differ by dtype);
//         kernel 20, bf16: Paired with GegluF32, kernel 11's own;
//         kernel 20, fp32: geglu_f64_kernel on the fp64 tensor cores (DMMA,
//           mma.sync m16n8k16 .f64): each 32-deep fp32 slice is loaded into
//           registers while the block multiplies the one before and becomes
//           doubles in shared memory, each element converted once a block;
//           a product of two fp32 values is exact in float64 and DMMA sums
//           in float64, so H is the float64 sum rounded once, as the plain
//           version's float64 product (only the order of the float64 sums
//           differs);
//     - row_quant with the gamma-LN over the inner width;
//     - y_q W2q^T on the int8 form (sm90::S8) with the DequantStore
//       epilogue, in x's dtype;
//   kernel 21 (five launches and a copy):
//     - x's LayerNorm and codes into y_q, a warp a row up to d 1024;
//     - h = y_q W1q^T on sm90::S8 with the DequantBiasGelu epilogue: g =
//       gelu(dequant + b1) into an fp32 scratch at the plan's pitch;
//     - g's codes a warp a row into g_q at a 64-byte pitch;
//     - W2q staged at that pitch where hid is not a multiple of 64 (one
//       cudaMemcpy2DAsync at every call: the product reads the weight it is
//       given); the down-projection's maps have K = hid, so TMA zero-fills
//       past it and the padding is never read;
//     - out = x + (dequant(g_q W2q^T) + b2) on sm90::S8 with DequantStore's
//       bias and residual, in x's dtype.
// What the tile products do about their bound: TMA keeps the ring full
// and wgmma reads both int8 operands straight from swizzled shared memory,
// so no thread spends registers or issue slots on fragment loads; the row
// passes between them are bound by bytes (g in fp32 is written once and
// read by the next row pass).
//
// Bit-equality. Each dequantisation, bias, residual and LayerNorm step is
// one IEEE operation in the plain version's order (__fmul_rn / __fadd_rn keep
// nvcc from contracting them into FMAs) and the gelu is PyTorch's CUDA
// expression, so the int8 codes equal the plain version's on the card
// (bf16 kernel 20: up to its fp32 sums' order). The s32 sums are exact in
// any order, so kernels 19 and 21 give the bits of the mma.sync kernels
// they replace (bench_q8.py bits holds them against that version's
// library, in both dtypes).
#include "gemm.cuh"
#include "gemm_sm90.cuh"

const void* stage_rows(const int64_t* plan, const void* w, void* stage, int rows,
                       int64_t row_bytes, cudaStream_t s);

namespace {

constexpr int kRowPer = 16;  // row_quant values a thread holds
constexpr int kRowChunk = kRowPer * kThreads;  // ... a row or chunk of 4096

// PyTorch's CUDA gelu (approximate="none"): x * 0.5 * (1 + erf(x * M_SQRT1_2))
__device__ __forceinline__ float gelu_torch(float v) {
  return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
}

// D (16x8, f64) += A (16x16, row) B (16x8, col), float64 (DMMA, the sm_90
// shape: m8n8k4 runs at half the H100's fp64 tensor rate). PTX ISA,
// mma.m16n8k16 .f64, g = lane / 4, t = lane % 4:
//   a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)]    b[i] = B[t + 4 i][g]
//   d[0..1] = D[g][2t..2t+1]    d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void dmma_16816(double d[4], const double a[8],
                                           const double b[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Kernel 20's fp32 up-projection: a block's tile is 128 rows of H by 128 of
// its columns, W1's "a" rows c0 .. c0 + 63 and the matching "gate" rows
// inner + c0 .. (c0 = 64 blockIdx.x), so the block writes g's columns
// c0 .. c0 + 63. 8 warps of 32 rows x 64 columns: warp (wm, wn) takes rows
// 32 wm .. (two m16 tiles), a columns 32 wn .. + 31 (n8 tiles nt 0-3) and
// their gate columns (nt 4-7), so acc[mt][nt] and acc[mt][nt + 4] are a and
// gate of one (row, column). K in 32-deep slices: each thread loads its 16-byte
// pieces of the next slice (fp32, as they lie) into registers while the
// block multiplies the current one, then converts them to double into the
// other of two shared buffers (each element converted once a block, not
// once a warp that reads it; the fp64 conversions share the DMMA's pipe).
// Rows are padded to 36 doubles: a warp's fragment loads (row g (+ 8),
// column t (+ 4 i) of a 16-deep step) fall in distinct banks.
constexpr int kDmmaM = 128, kDmmaN = 128, kDmmaK = 32, kDmmaThreads = 256;
constexpr int kDmmaLd = kDmmaK + 4;  // shared row (doubles) of a slice
constexpr int kDmmaPieces = kDmmaM * kDmmaK / 4 / kDmmaThreads;  // float4s a thread
struct DmmaTiles {
  double a[2][kDmmaM][kDmmaLd];
  double b[2][kDmmaN][kDmmaLd];
};

__global__ __launch_bounds__(kDmmaThreads, 1) void geglu_f64_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    float* __restrict__ g, int ldg, int M, int K, int inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DmmaTiles& sm = *reinterpret_cast<DmmaTiles*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4, wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kDmmaM, c0 = blockIdx.x * 64;
  // piece i of a thread: tile row (tid + 256 i) / 8, columns 4 ((tid % 8)) ..
  const int pr = tid / 8, pc = (tid % 8) * 4;
  const float* a_src = x + (int64_t)(m0 + pr) * K + pc;
  const float* b_src = w1 + (int64_t)(c0 + pr) * K + pc;  // "a" rows; gate: + inner
  float4 ra[kDmmaPieces], rb[kDmmaPieces];
  const auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kDmmaPieces; ++i) {
      const int r = pr + 32 * i;  // rows 0-63 of B are "a", 64-127 "gate"
      ra[i] = m0 + r < M ? *reinterpret_cast<const float4*>(a_src + (int64_t)32 * i * K + k0)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[i] = *reinterpret_cast<const float4*>(
          b_src + (int64_t)(r < 64 ? 32 * i : inner + 32 * i - 64) * K + k0);
    }
  };
  const auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kDmmaPieces; ++i) {
      double2* pa = reinterpret_cast<double2*>(&sm.a[buf][pr + 32 * i][pc]);
      double2* pb = reinterpret_cast<double2*>(&sm.b[buf][pr + 32 * i][pc]);
      pa[0] = make_double2(ra[i].x, ra[i].y);
      pa[1] = make_double2(ra[i].z, ra[i].w);
      pb[0] = make_double2(rb[i].x, rb[i].y);
      pb[1] = make_double2(rb[i].z, rb[i].w);
    }
  };
  double acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
  const int KT = K / kDmmaK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) fetch((kt + 1) * kDmmaK);
    const double(*as)[kDmmaLd] = sm.a[buf];
    const double(*bs)[kDmmaLd] = sm.b[buf];
#pragma unroll
    for (int kk = 0; kk < kDmmaK; kk += 16) {
      double af[2][8];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          af[mt][i] = as[32 * wm + 16 * mt + gq + 8 * (i & 1)][kk + tq + 4 * (i >> 1)];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // a columns (nt 0-3), then gate
        const double* br = bs[(nt >> 2) * 64 + 32 * wn + 8 * (nt & 3) + gq] + kk + tq;
        const double bf[4] = {br[0], br[4], br[8], br[12]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) dmma_16816(acc[mt][nt], af[mt], bf);
      }
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < KT) stash(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 32 * wm + 16 * mt + gq + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = c0 + 32 * wn + 8 * p + 2 * tq;
        const double* a = &acc[mt][p][2 * h];
        const double* gt = &acc[mt][p + 4][2 * h];
        *reinterpret_cast<float2*>(g + (int64_t)row * ldg + col) =
            make_float2((float)gt[0] * gelu_torch((float)a[0]),
                        (float)gt[1] * gelu_torch((float)a[1]));
      }
    }
}

constexpr size_t kDmmaSmem = sizeof(DmmaTiles);

__device__ __forceinline__ double block_sum_d(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by an earlier call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// V values of T from p into v (V 4: one 16-byte load of fp32, 8-byte of
// bf16)
template <int V, typename T>
__device__ __forceinline__ void load_vals(const T* p, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  }
}

// One block a row of `width` values (row stride ld_in): with kLN the
// LayerNorm y = (v - mean) * rstd * gamma (+ beta) (float64 statistics,
// rounded once), then scale = max(amax, 1e-8) / 127 and
// q = clip(rint(y / scale), -127, 127) into q (row stride ld_q >= width; the
// columns past width are zeros). Thread t takes V columns
// V (t + kThreads j) .. + V - 1 of a chunk of kRowChunk (V 4: one vector
// load and one 4-byte store of codes each; V 1 where the widths, strides or
// pointers do not allow it). A row of at most kRowChunk columns is read once
// and held in registers; a wider one is walked in chunks, each step (the
// sum, the centred squares, amax, the codes) reading its chunks again in the
// same order, so the float64 sums run in one fixed order.
template <typename T, bool kLN, int V>
__global__ __launch_bounds__(kThreads) void row_quant_kernel(
    const T* __restrict__ in, int ld_in, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ q, int ld_q,
    float* __restrict__ scale, int width, float eps) {
  constexpr int kGroups = kRowPer / V;
  __shared__ double redd[kThreads / 32];
  __shared__ float redf[kThreads / 32];
  const T* row = in + (int64_t)blockIdx.x * ld_in;
  const int chunks = (ld_q + kRowChunk - 1) / kRowChunk;
  const bool held = chunks == 1;
  // the first column of group j of the chunk at c0
  const auto col = [&](int c0, int j) { return c0 + V * (threadIdx.x + kThreads * j); };
  float v[kRowPer];
  const auto load = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int c = col(c0, j);
      if (c < width) {
        load_vals<V>(row + c, v + V * j);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[V * j + e] = 0.f;
      }
    }
  };
  float mean = 0.f, rstd = 0.f;
  // v = y of the chunk at c0, in place
  const auto norm = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int c = col(c0, j) + e;
        if (c < width) {
          float y = __fmul_rn(__fmul_rn(v[V * j + e] - mean, rstd), gamma[c]);
          if (beta != nullptr) y = __fadd_rn(y, beta[c]);
          v[V * j + e] = y;
        }
      }
    }
  };
  if (held) load(0);
  if (kLN) {
    double s = 0.0;
    for (int k = 0; k < chunks; ++k) {
      if (!held) load(k * kRowChunk);
#pragma unroll
      for (int j = 0; j < kRowPer; ++j) s += (double)v[j];  // zeros past width
    }
    mean = (float)(block_sum_d(s, redd) / width);
    double sq = 0.0;
    for (int k = 0; k < chunks; ++k) {
      const int c0 = k * kRowChunk;
      if (!held) load(c0);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (col(c0, j) + e < width) {
            const float cv = v[V * j + e] - mean;
            sq += (double)cv * (double)cv;
          }
        }
      }
    }
    rstd = (float)(1.0 / sqrt(block_sum_d(sq, redd) / width + (double)eps));
    if (held) norm(0);
  }
  float amax = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * kRowChunk;
    if (!held) {
      load(c0);
      if (kLN) norm(c0);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (col(c0, j) + e < width) amax = fmaxf(amax, fabsf(v[V * j + e]));
  }
  const float s = __fdiv_rn(fmaxf(block_max(amax, redf), 1e-8f), 127.f);
  int8_t* out = q + (int64_t)blockIdx.x * ld_q;
  const auto code = [&](int c, float y) {
    return c < width ? (int8_t)fminf(fmaxf(rintf(__fdiv_rn(y, s)), -127.f), 127.f)
                     : (int8_t)0;
  };
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * kRowChunk;
    if (!held) {
      load(c0);
      if (kLN) norm(c0);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int c = col(c0, j);
      if (c >= ld_q) continue;
      if constexpr (V == 1) {
        out[c] = code(c, v[j]);
      } else {
        uint32_t w = 0;
#pragma unroll
        for (int e = 0; e < V; ++e)
          w |= (uint32_t)(uint8_t)code(c + e, v[V * j + e]) << (8 * e);
        *reinterpret_cast<uint32_t*>(out + c) = w;
      }
    }
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// Lane `lane`'s kG groups of 4 values of a row of `width` (a multiple of 4)
// into v, group j from column 4 (lane + 32 j), zeros past width. Every load
// is issued before any value is used (a group past width reloads the row's
// last 4 values, then is zeroed): loads each followed by their use waited
// for one another.
template <int kG, typename T>
__device__ __forceinline__ void load_row(const T* src, int width, int lane, float* v) {
#pragma unroll
  for (int j = 0; j < kG; ++j)
    load_vals<4>(src + min(4 * (lane + 32 * j), width - 4), v + 4 * j);
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (4 * (lane + 32 * j) >= width) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * j + e] = 0.f;
    }
  }
}

// The codes of rows of at most kG * 128 values without the LayerNorm
// (kernel 19's x at kG 8, kernel 21's fp32 gelu output at kG 16): a warp a row,
// eight rows a block, 4 columns a lane in each of kG groups (group j at
// column 4 (lane + 32 j)) held in registers, the amax by shuffles. A block
// a row spent most of its time waiting on its barriers at such widths; max
// is order-free, so the scale and codes are row_quant_kernel's.
constexpr int kWarpRow = 1024;  // the widths of kG 8; kG 16 takes twice them
template <typename T, int kG>
__global__ __launch_bounds__(kThreads) void row_codes_kernel(
    const T* __restrict__ in, int ld_in, int8_t* __restrict__ q, int ld_q,
    float* __restrict__ scale, int n, int width) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* src = in + (int64_t)row * ld_in;
  float v[4 * kG];
  load_row<kG>(src, width, lane, v);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    if (4 * (lane + 32 * j) < width) {
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[4 * j + e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* out = q + (int64_t)row * ld_q;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c >= ld_q) continue;
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t code =
          c + e < width
              ? (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + e], s)), -127.f), 127.f)
              : (int8_t)0;
      w |= (uint32_t)(uint8_t)code << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(out + c) = w;
  }
  if (lane == 0) scale[row] = s;
}

// The LayerNorm and codes of rows of at most kWarpRow values (kernel 21's
// x): a warp a row, eight rows a block, 4 columns a lane in each of 8
// groups held in registers. The float64 sums keep row_quant_kernel's order
// (4 columns a thread, one chunk) exactly: group j of lane l holds what
// thread 32 j + l of that kernel's block held (its columns 4 (32 j + l) ..
// + 3; its other 12 values lie past kWarpRow and are zeros, whose +0.0 is
// added here once), each group's sums run the shuffle tree of that block's
// warp j over the same lanes, and the 8 groups then add in order as its
// warps did; so the mean, rstd, scale and codes are row_quant_kernel's bit
// for bit, without its 8192 one-row blocks and their barriers.
template <typename T>
__global__ __launch_bounds__(kThreads) void ln_codes_kernel(
    const T* __restrict__ in, int ld_in, const float* __restrict__ gamma,
    const float* __restrict__ beta, int8_t* __restrict__ q, int ld_q,
    float* __restrict__ scale, int n, int width, float eps) {
  constexpr int kG = kWarpRow / 128;  // the groups: row_quant_kernel's warps
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;
  const T* src = in + (int64_t)row * ld_in;
  // warp j's shuffle tree in block_sum_d
  const auto tree = [](double x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  };
  float v[4 * kG];
  load_row<kG>(src, width, lane, v);
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    double sj = 0.0;
    if (4 * (lane + 32 * j) < width) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sj += (double)v[4 * j + e];
      sj += 0.0;
    }
    s += tree(sj);
  }
  const float mean = (float)(s / width);
  double sq = 0.0;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    double sqj = 0.0;
    if (4 * (lane + 32 * j) < width) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cv = v[4 * j + e] - mean;
        sqj += (double)cv * (double)cv;
      }
    }
    sq += tree(sqj);
  }
  const float rstd = (float)(1.0 / sqrt(sq / width + (double)eps));
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (lane + 32 * j) + e;
      if (c < width) {
        float y = __fmul_rn(__fmul_rn(v[4 * j + e] - mean, rstd), gamma[c]);
        if (beta != nullptr) y = __fadd_rn(y, beta[c]);
        v[4 * j + e] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  int8_t* out = q + (int64_t)row * ld_q;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c >= ld_q) continue;
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t code =
          c + e < width
              ? (int8_t)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + e], sc)), -127.f), 127.f)
              : (int8_t)0;
      w |= (uint32_t)(uint8_t)code << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(out + c) = w;
  }
  if (lane == 0) scale[row] = sc;
}

// row_quant_kernel over n rows, 4 columns a thread where every width,
// stride and pointer allows it; rows of at most kWarpRow values with the
// LayerNorm (ln_codes_kernel) and of at most kWarpRow codes without it, or
// 2 kWarpRow fp32 ones (kernel 21's g), a warp a row (row_codes_kernel)
template <typename T, bool kLN>
cudaError_t row_quant(const T* in, int ld_in, const float* gamma, const float* beta,
                      int8_t* q, int ld_q, float* scale, int n, int width, float eps,
                      cudaStream_t s) {
  const bool vec = width % 4 == 0 && ld_in % 4 == 0 && ld_q % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  constexpr int kRows = kThreads / 32;
  const unsigned blocks = (n + kRows - 1) / kRows;
  if constexpr (!kLN && std::is_same<T, float>::value) {  // kernel 21's g
    if (vec && ld_q > kWarpRow && ld_q <= 2 * kWarpRow) {
      row_codes_kernel<T, 16><<<blocks, kThreads, 0, s>>>(in, ld_in, q, ld_q, scale, n,
                                                          width);
      return cudaGetLastError();
    }
  }
  if (kLN && vec && ld_q <= kWarpRow) {
    ln_codes_kernel<T><<<blocks, kThreads, 0, s>>>(in, ld_in, gamma, beta, q, ld_q, scale, n,
                                                   width, eps);
  } else if (!kLN && vec && ld_q <= kWarpRow) {
    row_codes_kernel<T, 8><<<blocks, kThreads, 0, s>>>(in, ld_in, q, ld_q, scale, n, width);
  } else if (vec) {
    row_quant_kernel<T, kLN, 4><<<n, kThreads, 0, s>>>(in, ld_in, gamma, beta, q, ld_q,
                                                      scale, width, eps);
  } else {
    row_quant_kernel<T, kLN, 1><<<n, kThreads, 0, s>>>(in, ld_in, gamma, beta, q, ld_q,
                                                      scale, width, eps);
  }
  return cudaGetLastError();
}

// The tail of kernels 19 and 20 from the down-projection's plan: y = the
// FFN's gamma-LN of each row of g (rows ldg elements apart), its codes into
// y_q (rows ldq bytes apart), then out = dequant(y_q W2q^T) on the int8 form
template <typename T>
cudaError_t ffn_tail(const int64_t* out_plan, const float* gs, int ldg,
                     const float* gamma, const int8_t* w2q, const float* s2,
                     int8_t* yq, int ldq, float* sy, T* out, int n, int d,
                     int inner, float eps, cudaStream_t s) {
  cudaError_t err = row_quant<float, true>(gs, ldg, gamma, nullptr, yq, ldq, sy, n,
                                           inner, eps, s);
  if (err != cudaSuccess) return err;
  const typename sm90::DequantStore<T>::Args oa{out, sy, s2, n, d, d};
  return sm90::gemm_from_plan<sm90::S8, sm90::DequantStore<T>, 128, 256>(
      out_plan, nullptr, yq, w2q, nullptr, nullptr, oa, n, d, inner, d, s);
}

// Kernel 19 from its plan (ops/quant.py::q8_plan: the paired int8
// up-projection's GemmPlan, then y_q W2q^T's): x's codes into x_q at the
// plan's pitch, g = gate * gelu(a) of the dequantised paired product into
// the fp32 scratch at its pitch, then the tail.
template <typename T>
cudaError_t ffn_q8(const int64_t* plan, const T* x, const int8_t* w1q,
                   const float* s1, const float* gamma, const int8_t* w2q,
                   const float* s2, int8_t* xq, float* sx, float* gs, int8_t* yq,
                   float* sy, T* out, int n, int d, int inner, float eps,
                   cudaStream_t s) {
  constexpr int P = sm90::kPlanValues;
  const int ldx = (int)plan[2];      // x_q's pitch: the up-projection's A map (bytes)
  const int ldg = (int)plan[19];     // g's pitch (fp32 elements)
  const int ldq = (int)plan[P + 2];  // y_q's: the down-projection's A map
  if (ldx < d || ldg < inner || ldg % 4 || ldq < inner) return cudaErrorInvalidValue;
  cudaError_t err =
      row_quant<T, false>(x, d, nullptr, nullptr, xq, ldx, sx, n, d, eps, s);
  if (err != cudaSuccess) return err;
  const sm90::GegluDequant::Args ga{gs, sx, s1, n, inner, ldg};
  err = sm90::gemm_from_plan<sm90::PairedS8, sm90::GegluDequant, 256>(
      plan, nullptr, xq, w1q, nullptr, nullptr, ga, n, 2 * inner, d, ldg, s);
  if (err != cudaSuccess) return err;
  return ffn_tail<T>(plan + P, gs, ldg, gamma, w2q, s2, yq, ldq, sy, out, n, d, inner,
                     eps, s);
}

// Kernel 20 from its plan (ops/quant.py::q8wide_plan: the paired GEGLU
// product's GemmPlan, then y_q W2q^T's in the int8 form): g = gate * gelu(a)
// into the fp32 scratch at the plan's pitch (bf16: the tile product; fp32:
// geglu_f64_kernel), the gamma-LN and codes of each row, the int8 product.
template <typename T>
cudaError_t ffn_q8wide(const int64_t* plan, const T* x, const T* w1,
                       const float* gamma, const int8_t* w2q, const float* s2,
                       float* gs, int8_t* yq, float* sy, T* out, int n, int d,
                       int inner, float eps, cudaStream_t s) {
  constexpr int P = sm90::kPlanValues;
  const int ldg = (int)plan[19];     // g's pitch (fp32 elements)
  const int ldq = (int)plan[P + 2];  // y_q's: the int8 product's A map (bytes)
  if (ldg < inner || ldg % 4 || ldq < inner) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const sm90::GegluF32::Args ga{gs, n, inner, ldg};
    err = sm90::gemm_from_plan<sm90::Paired, sm90::GegluF32, 256>(
        plan, nullptr, x, w1, nullptr, nullptr, ga, n, 2 * inner, d, ldg, s);
  } else {
    static bool smem_set = false;
    if (!smem_set) {
      err = cudaFuncSetAttribute(geglu_f64_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kDmmaSmem);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    geglu_f64_kernel<<<dim3(inner / 64, (n + kDmmaM - 1) / kDmmaM), kDmmaThreads,
                       kDmmaSmem, s>>>(x, w1, gs, ldg, n, d, inner);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return ffn_tail<T>(plan + P, gs, ldg, gamma, w2q, s2, yq, ldq, sy, out, n, d, inner,
                     eps, s);
}

// Kernel 21 from its plan (ops/quant.py::ln_mlp_q8_plan: the int8
// up-projection's GemmPlan, then the down-projection's): x's LayerNorm and
// codes into y_q at the plan's pitch, g = gelu(dequant(y_q W1q^T) + b1)
// into the fp32 scratch at its pitch, g's codes into g_q at the
// down-projection's pitch (a warp a row up to 2048 codes), W2q staged at
// that pitch where hid is not one, then out = x + (dequant(g_q W2q^T) +
// b2) in x's dtype. The down-projection's map has K = hid, so TMA
// zero-fills past it and g_q's padding columns are never read.
template <typename T>
cudaError_t ln_mlp_q8(const int64_t* plan, const T* x, const float* lng, const float* lnb,
                      const int8_t* w1q, const float* s1, const float* b1,
                      const int8_t* w2q, const float* s2, const float* b2, int8_t* w2s,
                      int8_t* yq, float* sy, float* gs, int8_t* gq, float* sg, T* out,
                      int n, int d, int hid, float eps, cudaStream_t s) {
  constexpr int P = sm90::kPlanValues;
  const int ldy = (int)plan[2];      // y_q's pitch: the up-projection's A map (bytes)
  const int ldg = (int)plan[19];     // g's pitch (fp32 elements)
  const int ldq = (int)plan[P + 2];  // g_q's: the down-projection's A map (bytes)
  if (ldy < d || ldg < hid || ldg % 4 || ldq < hid) return cudaErrorInvalidValue;
  const auto* w2r = static_cast<const int8_t*>(stage_rows(plan + P, w2q, w2s, d, hid, s));
  if (w2r == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = row_quant<T, true>(x, d, lng, lnb, yq, ldy, sy, n, d, eps, s);
  if (err != cudaSuccess) return err;
  const sm90::DequantBiasGelu::Args ga{gs, sy, s1, b1, n, hid, ldg};
  if ((err = sm90::gemm_from_plan<sm90::S8, sm90::DequantBiasGelu, 128>(
           plan, nullptr, yq, w1q, nullptr, nullptr, ga, n, hid, d, ldg, s)) != cudaSuccess ||
      (err = row_quant<float, false>(gs, ldg, nullptr, nullptr, gq, ldq, sg, n, hid, eps,
                                     s)) != cudaSuccess)
    return err;
  const typename sm90::DequantStore<T>::Args oa{out, sg, s2, n, d, d, b2, x};
  return sm90::gemm_from_plan<sm90::S8, sm90::DequantStore<T>, 128, 256>(
      plan + P, nullptr, gq, w2r, nullptr, nullptr, oa, n, d, hid, d, s);
}

}  // namespace

// plan: ops/quant.py::Q8Plan (42 int64, the same for bf16 and fp32 x).
// Scratch: xq (n, d) int8, g (n, inner) fp32 and yq (n, inner) int8 at the
// plan's pitches, sx (n), sy (n). W1q (2 * inner, d), W2q (d, inner).
AMT_EXPORT int amt_ffn_q8(const int64_t* plan, const void* x, const void* w1q,
                          const void* s1, const void* gamma, const void* w2q,
                          const void* s2, void* xq, void* sx, void* g, void* yq,
                          void* sy, void* out, int n, int d, int inner, float eps,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (plan == nullptr || n < 0 || d % 128 || inner % 128) return cudaErrorInvalidValue;
  const auto* w1 = static_cast<const int8_t*>(w1q);
  const auto* w2 = static_cast<const int8_t*>(w2q);
  const auto* f1 = static_cast<const float*>(s1);
  const auto* f2 = static_cast<const float*>(s2);
  const auto* gm = static_cast<const float*>(gamma);
  auto* xqi = static_cast<int8_t*>(xq);
  auto* yqi = static_cast<int8_t*>(yq);
  auto* sxf = static_cast<float*>(sx);
  auto* syf = static_cast<float*>(sy);
  auto* gs = static_cast<float*>(g);
  if (dtype == AMT_BF16)
    return ffn_q8(plan, static_cast<const bf16*>(x), w1, f1, gm, w2, f2, xqi, sxf, gs,
                  yqi, syf, static_cast<bf16*>(out), n, d, inner, eps, s);
  if (dtype == AMT_F32)
    return ffn_q8(plan, static_cast<const float*>(x), w1, f1, gm, w2, f2, xqi, sxf, gs,
                  yqi, syf, static_cast<float*>(out), n, d, inner, eps, s);
  return cudaErrorInvalidValue;
}

// plan: ops/quant.py::Q8Plan (42 int64; fp32 reads the GEGLU product's
// g pitch only). Scratch: g (n, inner) fp32 and yq (n, inner) int8 at the
// plan's pitches, sy (n). W1 (2 * inner, d) in x's dtype, W2q (d, inner).
AMT_EXPORT int amt_ffn_q8wide(const int64_t* plan, const void* x, const void* w1,
                              const void* gamma, const void* w2q, const void* s2,
                              void* g, void* yq, void* sy, void* out, int n, int d,
                              int inner, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (plan == nullptr || n < 0 || d % 128 || inner % 128) return cudaErrorInvalidValue;
  const auto* w2 = static_cast<const int8_t*>(w2q);
  const auto* f2 = static_cast<const float*>(s2);
  const auto* gm = static_cast<const float*>(gamma);
  auto* gs = static_cast<float*>(g);
  auto* yqi = static_cast<int8_t*>(yq);
  auto* syf = static_cast<float*>(sy);
  if (dtype == AMT_BF16)
    return ffn_q8wide(plan, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                      gm, w2, f2, gs, yqi, syf, static_cast<bf16*>(out), n, d, inner,
                      eps, s);
  if (dtype == AMT_F32)
    return ffn_q8wide(plan, static_cast<const float*>(x), static_cast<const float*>(w1),
                      gm, w2, f2, gs, yqi, syf, static_cast<float*>(out), n, d, inner,
                      eps, s);
  return cudaErrorInvalidValue;
}

// plan: ops/quant.py::LnMlpQ8Plan (42 int64, the same for bf16 and fp32 x).
// W1q (hid, d) and W2q (d, hid) contiguous; b1, b2 and the LN affine fp32.
// Scratch: yq (n, d) int8, g (n, hid) fp32 and gq (n, hid) int8 at the
// plan's pitches, sy and sg (n); w2s (d, pitch) int8 where the plan stages
// W2q (else unused).
AMT_EXPORT int amt_ln_mlp_q8(const int64_t* plan, const void* x, const void* lng,
                             const void* lnb, const void* w1q, const void* s1,
                             const void* b1, const void* w2q, const void* s2,
                             const void* b2, void* w2s, void* yq, void* sy, void* g,
                             void* gq, void* sg, void* out, int n, int d, int hid,
                             float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (plan == nullptr || n < 0 || d % 128 || hid % 8) return cudaErrorInvalidValue;
  const auto* lg = static_cast<const float*>(lng);
  const auto* lb = static_cast<const float*>(lnb);
  const auto* w1 = static_cast<const int8_t*>(w1q);
  const auto* w2 = static_cast<const int8_t*>(w2q);
  const auto* f1 = static_cast<const float*>(s1);
  const auto* f2 = static_cast<const float*>(s2);
  const auto* c1 = static_cast<const float*>(b1);
  const auto* c2 = static_cast<const float*>(b2);
  auto* w2st = static_cast<int8_t*>(w2s);
  auto* yqi = static_cast<int8_t*>(yq);
  auto* gqi = static_cast<int8_t*>(gq);
  auto* syf = static_cast<float*>(sy);
  auto* sgf = static_cast<float*>(sg);
  auto* gs = static_cast<float*>(g);
  if (dtype == AMT_BF16)
    return ln_mlp_q8(plan, static_cast<const bf16*>(x), lg, lb, w1, f1, c1, w2, f2, c2,
                     w2st, yqi, syf, gs, gqi, sgf, static_cast<bf16*>(out), n, d, hid,
                     eps, s);
  if (dtype == AMT_F32)
    return ln_mlp_q8(plan, static_cast<const float*>(x), lg, lb, w1, f1, c1, w2, f2, c2,
                     w2st, yqi, syf, gs, gqi, sgf, static_cast<float*>(out), n, d, hid,
                     eps, s);
  return cudaErrorInvalidValue;
}
