// One Hopper tile product on TMA and wgmma, with the epilogue a template
// argument:
//   C (M, N) = epilogue(A B^T)            one product, or
//   C (M, N) = epilogue(A B^T, A2 B2^T)   a dual product over the same tile
//                                          and the same K,
// A (M, K) and B (N, K) bf16, sums in fp32, or both int8 with exact s32
// sums (S8: wgmma's m64nBNk32 .s32.s8.s8, K-major operands only). A K slice
// is 128 bytes whatever the type (64 bf16 or 128 int8 elements): one
// swizzle row, the same stage bytes and the same 32-byte descriptor step a
// wgmma, so the ring, the producer and the barriers serve both. Each bf16
// operand is read
//   - K-major (kK): a row-major (rows, K) matrix, K contiguous (x, or W1
//     in the torch Linear layout: wgmma's K-major B as it stands), or
//   - MN-major (kMN): a row-major (K, rows) matrix, rows contiguous (W2
//     read as the B of dy W2, dH and yc read as the A and B of the weight
//     gradient dH^T yc), through wgmma's transpose bit;
// or B paired (Paired, the GEGLU products of kernels 11 and 20; PairedS8,
// kernel 19's int8 one): W1's "a" and "gate" rows loaded as two K-major
// half boxes of one tile, so a thread holds a and gate of the same inner
// column.
// The epilogue is a struct with an Args type and a run<BN>() the kernel
// calls on a warpgroup's registers; a .cu brings its own or takes one of
// these:
//   - BiasGelu:     C = bf16(gelu(A B^T + bias)), the exact erff GELU;
//   - BiasResidual: C = bf16(A B^T + bias (+ res)), res (M, N) bf16 or null
//     (the bias fp32 or bf16, added in fp32: kernels 7 and 2);
//   - StoreF32:     C = A B^T in fp32 (weight gradients, dy_ln);
//   - StoreBf16:    C = bf16(A B^T) (dh, the FFN's out and dx);
//   - GeluBwd:      the dual product H = x W1^T, dG = dy W2 of the GELU-MLP
//     backwards (kernels 6 and 8): G = bf16(gelu(H + b1)), dH = dG gelu'(H
//     + b1) in bf16, and dH's fp32 column sums per 64 rows (for db1);
//   - GegluF32:     g = gate * gelu(a) in fp32 over paired columns (the
//     GEGLU up-projections of kernels 11 and 20);
//   - GegluDequant: the same from PairedS8's s32 sums, a and gate each
//     dequantised first (kernel 19's up-projection);
//   - DequantStore: C = (float(acc) * s_row) * s_col in fp32 or bf16, each
//     product rounded, then optionally + bias and res + C (the int8 form:
//     the down-projections of kernels 19 and 20, kernel 21's residual
//     one);
//   - DequantBiasGelu: g = gelu(dequant + bias) in fp32 (the int8 form:
//     kernel 21's up-projection).
//
// Shape of a block:
//   - 128 rows x BN columns of C: two consumer warpgroups of 64 rows, each
//     holding 64 x BN fp32 accumulators (two sets in a dual product), and
//     one producer warp of which one thread issues TMA loads;
//   - K in slices of 128 bytes into a ring of kStages stages with full (TMA
//     bytes) and empty (eight consumer warps) mbarriers. A K-major tile is
//     one rank-2 box of (one slice of K, rows) with 128-byte swizzle; an
//     MN-major tile is rows / 64 boxes of (64 MN, 64 K), one 128-byte
//     swizzle row of MN a K row, the boxes 8 KB apart (wgmma's leading byte
//     offset; 8 K rows are 1 KB, its stride byte offset). TMA zero-fills
//     past M, N and K, so ragged tails add nothing to any sum and need no
//     padded copy. A row pitch that is only 16-byte aligned slows TMA
//     (bench_mlp.py's "rows 16-byte aligned" rows): the wrappers give the
//     scratches 64-byte aligned rows and stage W2 at such a pitch;
//   - each slice is four SS wgmma (m64nBNk16 bf16, m64nBNk32 s8) a
//     product; a slice's products stay in flight while the next slice's
//     are issued (wgmma_wait<1>), and its stage goes back to the producer
//     when they complete;
//   - the epilogue runs in registers and writes through the freed ring with
//     padded rows (no bank conflicts), then 16-byte row pieces below M and
//     N; column sums an epilogue takes (a bias gradient) run in a fixed
//     order: a warp's 16 rows by shuffles, then its warpgroup's 4 warps in
//     order, one fp32 partial row per 64 rows.
// Split K (blockIdx.z): a weight gradient reduces over all n rows, and at
// ViTVQGAN's shapes its tiles are fewer than the SMs; the plan splits K
// into grid.z ranges of kslices slices, each block writes an fp32 partial,
// and sum_splits adds the partials in order. No atomics: every sum runs in
// one fixed order, so two calls on the same inputs are bit-equal.
// BN 128 runs two blocks an SM (3 stages, at most 112 registers a thread),
// so one block's epilogue overlaps the other's products; BN 256 and the
// dual product at BN 128 one block an SM (up to 224 registers). The host
// plan (ops/gemm_sm90.py::GemmPlan) holds each map's dims, row pitch, box
// and majorness, the grid, the split, the tile width and the shared
// memory; gemm_from_plan checks it against the product, encodes the maps
// and launches.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace sm90 {
// Internal linkage: each source that includes this header gets its own
// kernels and launch state (a function-local static of a template with
// external linkage would be one object across every library loaded).
namespace {

constexpr int kBM = 128;       // rows of C a block
constexpr int kBK = 64;        // bf16 K a stage
constexpr int kSliceBytes = 128;  // bytes of K a stage, whatever the type
constexpr int kThreads = 288;  // two consumer warpgroups + one producer warp
constexpr int kSwizzle = 128;  // bytes: one row of a K slice
constexpr int kSlab = 64;      // MN elements in one swizzle row
constexpr uint32_t kSlabBytes = kSlab * kBK * 2;  // one (64 MN, 64 K) box
constexpr int kPlanValues = 21;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

enum Major { kK = 0, kMN = 1 };

// The operands' majorness: A and B, and for a dual product A2 and B2.
template <int kMajA_, int kMajB_, int kMajA2_ = -1, int kMajB2_ = -1>
struct Form {
  static constexpr int kMajA = kMajA_, kMajB = kMajB_;
  static constexpr int kMajA2 = kMajA2_, kMajB2 = kMajB2_;
  static constexpr int kDual = kMajA2_ >= 0 ? 1 : 0;
  static constexpr int kPairB = 0;
  static constexpr int kS8 = 0;
  using Acc = float;
};

// The int8 form (the down-projections of kernels 19 and 20): A and B int8,
// K-major (the only majorness wgmma takes for int8), exact s32 sums. Its
// tiles, ring and descriptors are the bf16 form's byte for byte: a slice is
// 128 int8 of K.
struct S8 : Form<kK, kK> {
  static constexpr int kS8 = 1;
  using Acc = int;
};

// Elements of K in one slice of a form's operands.
template <class Fm>
__host__ __device__ constexpr int slice_k() {
  return Fm::kS8 ? kSliceBytes : kSliceBytes / 2;
}

// The paired-column form of the GEGLU product (kernels 11 and 20): A and B
// K-major, B = W1 (2 inner, K) whose rows [0, inner) are the "a" half and
// [inner, 2 inner) the "gate" half. Block x's B tile is two boxes of BN / 2
// rows stacked in the stage: W1 rows c0 .. c0 + BN/2 - 1 and inner + c0 ..,
// c0 = x BN / 2, so accumulator column j and j + BN / 2 are a and gate of
// inner column c0 + j, in the same thread (N = 2 inner, a multiple of BN:
// inner = gridDim.x BN / 2).
struct Paired : Form<kK, kK> {
  static constexpr int kPairB = 1;
};

// The paired form on int8 operands (kernel 19's up-projection): x_q and
// W1q K-major, W1q's half boxes 128 int8 of K deep, exact s32 sums.
struct PairedS8 : Paired {
  static constexpr int kS8 = 1;
  using Acc = int;
};

template <int BN, int kDual>
struct Config;
template <>
struct Config<128, 0> {
  static constexpr int kStages = 3, kBlocksPerSM = 2;
};
template <>
struct Config<256, 0> {
  static constexpr int kStages = 4, kBlocksPerSM = 1;
};
template <>
struct Config<128, 1> {
  static constexpr int kStages = 3, kBlocksPerSM = 1;
};


// A stage of the ring: A, B (and A2, B2) tiles, each a multiple of the
// 1024-byte swizzle atom.
template <int BN, int kDual>
struct Ring {
  static constexpr int kStages = Config<BN, kDual>::kStages;
  static constexpr uint32_t kA = kBM * kSliceBytes, kB = BN * kSliceBytes;
  static constexpr uint32_t kStage = (1 + kDual) * (kA + kB);
  static constexpr uint32_t kBytes = kStages * kStage;
};

// Shared memory; every tile starts on a 1024-byte boundary: the base is
// aligned by hand.
template <int BN, int kDual>
struct Tiles {
  uint8_t ring[Ring<BN, kDual>::kStages][Ring<BN, kDual>::kStage];
  uint64_t full[Ring<BN, kDual>::kStages], empty[Ring<BN, kDual>::kStages];
};

template <int BN, int kDual>
constexpr size_t smem_bytes() {
  return sizeof(Tiles<BN, kDual>) + 1024;
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

// -- epilogue helpers ----------------------------------------------------------
// A warpgroup's accumulators (w = warp in the warpgroup, g = lane / 4,
// t = lane % 4): acc[4i + e] is C[16w + g + 8 (e / 2)][8i + 2t + (e % 2)]
// of its 64 x BN tile.

// A warpgroup's 64 x BN tile of T staged in shared memory with padded rows,
// then written as 16-byte row pieces below M and N.
template <int BN, typename T>
struct Staged {
  static constexpr int kRowBytes = BN * (int)sizeof(T) + 16;
  static constexpr int kBytes = 64 * kRowBytes;

  // (v0, v1) at local row r, columns cl, cl + 1
  static __device__ __forceinline__ void put(uint8_t* st, int r, int cl,
                                             float v0, float v1) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<uint32_t*>(st + r * kRowBytes + cl * 2) =
          pack_bf16x2(v0, v1);
    else
      *reinterpret_cast<float2*>(st + r * kRowBytes + cl * 4) =
          make_float2(v0, v1);
  }
  // After the warpgroup's barrier: rows m0r.. of out, ld elements apart.
  static __device__ __forceinline__ void flush(const uint8_t* st, T* out,
                                               int64_t ld, int m0r, int n0,
                                               int m, int n) {
    constexpr int kPer = 16 / (int)sizeof(T), kChunks = BN / kPer;
    const int tid = threadIdx.x % 128;
#pragma unroll 4
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks, ch = idx % kChunks;
      const int row = m0r + r, col = n0 + ch * kPer;
      if (row < m && col < n)
        *reinterpret_cast<uint4*>(out + (int64_t)row * ld + col) =
            *reinterpret_cast<const uint4*>(st + r * kRowBytes + ch * 16);
    }
  }
};

// Column sums of a warpgroup's 64 rows in a fixed order: cs[2i + u] holds
// this thread's sum over its two rows of column 8i + 2t + u; the warp's 16
// rows by shuffles over g, then the 4 warps in order through red (4 x BN
// floats of shared memory), into out[n0 + col] below N. Ends with the
// warpgroup's barrier (id 2 + c).
template <int BN>
__device__ __forceinline__ void colsum_rows(float (&cs)[BN / 4], float* red,
                                            float* out, int n0, int n,
                                            int c) {
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int w = tid / 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BN / 4; ++j) {
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1)
      cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], o);
  }
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      red[w * BN + 8 * i + 2 * t] = cs[2 * i];
      red[w * BN + 8 * i + 2 * t + 1] = cs[2 * i + 1];
    }
  }
  hopper::named_barrier_sync(2 + c, 128);
  for (int col = tid; col < BN; col += 128)
    if (n0 + col < n)
      out[n0 + col] = ((red[col] + red[BN + col]) + red[2 * BN + col]) +
                      red[3 * BN + col];
}

// -- epilogues -------------------------------------------------------------------

struct GemmArgs {
  const void* bias;            // (N,) fp32, or bf16 when bias_bf16
  const __nv_bfloat16* res;    // BiasResidual: (M, N) bf16, or null
  __nv_bfloat16* c;            // (M, N) bf16, rows ldc elements apart
  int m, n, k;
  int ldc;                     // row stride of C and res (elements)
  int bias_bf16;
};

// The bias epilogues of kernels 7 and 2: bias, then GELU or the residual,
// in fp32; bf16 into the warpgroup's padded staging rows, then 16-byte row
// pieces below M and N.
template <int BN, bool kGelu, typename TB>
__device__ __forceinline__ void bias_epilogue(const float (&acc)[BN / 2],
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
    if constexpr (kGelu) {
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

template <bool kGelu>
struct BiasAct {
  using Args = GemmArgs;
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    uint8_t* stage = ring + c * 64 * (2 * BN + 16);
    if (a.bias_bf16)
      bias_epilogue<BN, kGelu>(acc, a, static_cast<const __nv_bfloat16*>(a.bias),
                               stage, m0r, n0, c);
    else
      bias_epilogue<BN, kGelu>(acc, a, static_cast<const float*>(a.bias), stage,
                               m0r, n0, c);
  }
};
using BiasGelu = BiasAct<true>;
using BiasResidual = BiasAct<false>;

// C = A B^T as it is summed, in T (fp32 or bf16). With a split K, block z
// writes its partial to c + z * split (an (M, N) fp32 plane).
template <typename T>
struct Store {
  struct Args {
    T* c;
    int m, n, ldc;
    int64_t split;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN, T>;
    uint8_t* st = ring + c * S::kBytes;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      S::put(st, rl, 8 * i + 2 * t, acc[4 * i], acc[4 * i + 1]);
      S::put(st, rl + 8, 8 * i + 2 * t, acc[4 * i + 2], acc[4 * i + 3]);
    }
    hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.c + blockIdx.z * a.split, a.ldc, m0r, n0, a.m, a.n);
  }
};
using StoreF32 = Store<float>;
using StoreBf16 = Store<__nv_bfloat16>;

// The dual product's epilogue of the GELU-MLP backwards (kernel 6 on yc =
// LN(x), kernel 8 on x): acc = x W1^T and acc2 = dy W2 of a warpgroup's
// 64 x BN tile (rows m0r.., hidden columns n0..).
struct GeluBwd {
  struct Args {
    const float* b1;        // (hid,) fp32
    __nv_bfloat16* g;       // (n, hid): bf16(gelu(H)), rows ld elements apart
    __nv_bfloat16* dh;      // (n, hid): bf16(dH)
    float* dhpart;          // (2 * row tiles, hid): fp32 column sums of dH
    int m, n, ld;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&h)[BN / 2],
                                             const float (&dg)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN, __nv_bfloat16>;
    static_assert(4 * S::kBytes + 8 * BN * 4 <= Ring<BN, 1>::kBytes,
                  "the epilogue's staging fits the ring");
    uint8_t* gs = ring + c * 2 * S::kBytes;
    uint8_t* ds = gs + S::kBytes;
    float* red = reinterpret_cast<float*>(ring + 4 * S::kBytes) + c * 4 * BN;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    float cs[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = n0 + cl;
      // hid % 8 == 0: both columns or neither; past hid, W1's and W2's
      // zero-filled tiles give H = 0 and dG = 0, so dH = 0
      const float2 bb = col < a.n ? bias_pair(a.b1, col) : make_float2(0.f, 0.f);
      float gv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float hv = h[4 * i + e] + ((e & 1) ? bb.y : bb.x);
        const float phi = 0.5f * (1.f + erff(hv * kInvSqrt2));
        const float pdf = expf(-0.5f * hv * hv) * kInvSqrt2Pi;
        gv[e] = hv * phi;
        dv[e] = dg[4 * i + e] * (phi + hv * pdf);  // rows past n: dy = 0
      }
      S::put(gs, rl, cl, gv[0], gv[1]);
      S::put(gs, rl + 8, cl, gv[2], gv[3]);
      S::put(ds, rl, cl, dv[0], dv[1]);
      S::put(ds, rl + 8, cl, dv[2], dv[3]);
      cs[2 * i] = dv[0] + dv[2];
      cs[2 * i + 1] = dv[1] + dv[3];
    }
    colsum_rows<BN>(cs, red, a.dhpart + (int64_t)(2 * blockIdx.y + c) * a.n,
                    n0, a.n, c);
    S::flush(gs, a.g, a.ld, m0r, n0, a.m, a.n);
    S::flush(ds, a.dh, a.ld, m0r, n0, a.m, a.n);
  }
};

// The GEGLU up-projection's epilogue (bf16, paired columns: kernels 11 and
// 20): acc[4i + e] and acc[4(i + BN/16) + e] are a and gate of inner column
// n0/2 + 8i + 2t + (e % 2); g = gate * gelu(a) in fp32 through the
// warpgroup's padded staging rows, then 16-byte row pieces below M and
// inner.
struct GegluF32 {
  struct Args {
    float* g;  // (M, inner) fp32, rows ldg elements apart
    int m, inner, ldg;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN / 2, float>;
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

// (float(acc) * s_row) * s_col, each product rounded as the plain
// version's (int_dot(...) * s_row) * s_col.
__device__ __forceinline__ float dequant_s8(int acc, float sr, float sc) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc);
}

// res[0], res[1] of T as fp32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The paired int8 form's epilogue (kernel 19): acc[4i + e] and
// acc[4(i + BN/16) + e] are the s32 sums of a and gate of inner column
// c = n0/2 + 8i + 2t + (e % 2), dequantised as (float(acc) * s_row[row]) *
// s_col[c] and ... * s_col[inner + c], each product rounded; then g = gate *
// gelu(a) in fp32 as GegluF32 writes it. Rows past M read no scale.
struct GegluDequant {
  struct Args {
    float* g;            // (M, inner) fp32, rows ldg elements apart
    const float* s_row;  // (M,): x's row scales
    const float* s_col;  // (2 inner,): W1q's channel scales
    int m, inner, ldg;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const int (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN / 2, float>;
    constexpr int kHalf = BN / 16;
    uint8_t* st = ring + c * S::kBytes;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    const float sr[2] = {m0r + rl < a.m ? a.s_row[m0r + rl] : 0.f,
                         m0r + rl + 8 < a.m ? a.s_row[m0r + rl + 8] : 0.f};
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int col = n0 / 2 + 8 * i + 2 * t;
      const float2 sa = *reinterpret_cast<const float2*>(a.s_col + col);
      const float2 sg = *reinterpret_cast<const float2*>(a.s_col + a.inner + col);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = sr[e / 2];
        const float av = dequant_s8(acc[4 * i + e], r, e % 2 ? sa.y : sa.x);
        const float gv = dequant_s8(acc[4 * (i + kHalf) + e], r, e % 2 ? sg.y : sg.x);
        v[e] = gv * gelu_exact(av);
      }
      S::put(st, rl, 8 * i + 2 * t, v[0], v[1]);
      S::put(st, rl + 8, 8 * i + 2 * t, v[2], v[3]);
    }
    hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.g, a.ldg, m0r, n0 / 2, a.m, a.inner);
  }
};

// The int8 form's epilogue: C = (float(acc) * s_row[row]) * s_col[col],
// then, where given, C + bias[col] and res[row][col] + C, each step one
// IEEE operation in the plain version's order, in T (fp32 or bf16); the s32
// sums are exact, so equal codes give equal bits in any sum order.
template <typename T>
struct DequantStore {
  struct Args {
    T* c;                // (M, N), rows ldc elements apart
    const float* s_row;  // (M,)
    const float* s_col;  // (N,)
    int m, n, ldc;
    const float* bias = nullptr;  // (N,) fp32, or null
    const T* res = nullptr;       // (M, N) at ldc, or null
  };
  template <int BN>
  static __device__ __forceinline__ void run(const int (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN, T>;
    uint8_t* st = ring + c * S::kBytes;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    const int row0 = m0r + rl, row1 = row0 + 8;
    const float sr0 = row0 < a.m ? a.s_row[row0] : 0.f;
    const float sr1 = row1 < a.m ? a.s_row[row1] : 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = n0 + cl;
      if (col >= a.n) continue;  // N % 8 == 0: col + 1 < N as well
      const float sc0 = a.s_col[col], sc1 = a.s_col[col + 1];
      float v[4] = {dequant_s8(acc[4 * i], sr0, sc0),
                    dequant_s8(acc[4 * i + 1], sr0, sc1),
                    dequant_s8(acc[4 * i + 2], sr1, sc0),
                    dequant_s8(acc[4 * i + 3], sr1, sc1)};
      if (a.bias != nullptr) {
        const float2 bb = bias_pair(a.bias, col);
        v[0] = __fadd_rn(v[0], bb.x);
        v[1] = __fadd_rn(v[1], bb.y);
        v[2] = __fadd_rn(v[2], bb.x);
        v[3] = __fadd_rn(v[3], bb.y);
      }
      if (a.res != nullptr) {
        if (row0 < a.m) {
          const float2 r = load_pair(a.res + (int64_t)row0 * a.ldc + col);
          v[0] = __fadd_rn(r.x, v[0]);
          v[1] = __fadd_rn(r.y, v[1]);
        }
        if (row1 < a.m) {
          const float2 r = load_pair(a.res + (int64_t)row1 * a.ldc + col);
          v[2] = __fadd_rn(r.x, v[2]);
          v[3] = __fadd_rn(r.y, v[3]);
        }
      }
      S::put(st, rl, cl, v[0], v[1]);
      S::put(st, rl + 8, cl, v[2], v[3]);
    }
    hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.c, a.ldc, m0r, n0, a.m, a.n);
  }
};

// The int8 form's GELU epilogue (kernel 21's up-projection): g = gelu(
// dequant(acc) + bias) in fp32, the dequantisation and the bias add each one
// IEEE operation and the gelu PyTorch's CUDA expression, x * 0.5 * (1 +
// erf(x / sqrt 2)), so equal codes give the plain version's g bit for bit.
struct DequantBiasGelu {
  struct Args {
    float* g;            // (M, N) fp32, rows ldg elements apart
    const float* s_row;  // (M,)
    const float* s_col;  // (N,)
    const float* bias;   // (N,) fp32
    int m, n, ldg;
  };
  static __device__ __forceinline__ float gelu_torch(float v) {
    return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
  }
  template <int BN>
  static __device__ __forceinline__ void run(const int (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = Staged<BN, float>;
    uint8_t* st = ring + c * S::kBytes;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    const float sr0 = m0r + rl < a.m ? a.s_row[m0r + rl] : 0.f;
    const float sr1 = m0r + rl + 8 < a.m ? a.s_row[m0r + rl + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = n0 + cl;
      if (col >= a.n) continue;  // N % 8 == 0: col + 1 < N as well
      const float sc0 = a.s_col[col], sc1 = a.s_col[col + 1];
      const float2 bb = bias_pair(a.bias, col);
      S::put(st, rl, cl,
             gelu_torch(__fadd_rn(dequant_s8(acc[4 * i], sr0, sc0), bb.x)),
             gelu_torch(__fadd_rn(dequant_s8(acc[4 * i + 1], sr0, sc1), bb.y)));
      S::put(st, rl + 8, cl,
             gelu_torch(__fadd_rn(dequant_s8(acc[4 * i + 2], sr1, sc0), bb.x)),
             gelu_torch(__fadd_rn(dequant_s8(acc[4 * i + 3], sr1, sc1), bb.y)));
    }
    hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.g, a.ldg, m0r, n0, a.m, a.n);
  }
};

// -- the kernel ------------------------------------------------------------------

// The TMA loads of one operand tile (rows r0.. of the operand, K slice kt
// of kSliceK elements).
template <int kMaj, int kRows, int kSliceK = kBK>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int kt, int r0) {
  if constexpr (kMaj == kK) {
    hopper::tma_load_2d(dst, map, bar, kt * kSliceK, r0);  // box (slice, kRows)
  } else {
#pragma unroll
    for (int j = 0; j < kRows / kSlab; ++j)  // boxes (64 MN, 64 K)
      hopper::tma_load_2d(dst + j * kSlabBytes, map, bar, r0 + j * kSlab,
                          kt * kBK);
  }
}

// The descriptor of rows r0.. (a multiple of 64) of an operand tile, and the
// bytes one k step (16 bf16 or 32 int8) moves it: 32 along a K-major swizzle
// row, 16 K rows (2 KB) down an MN-major slab.
template <int kMaj>
__device__ __forceinline__ uint64_t tile_desc(const uint8_t* tile, int r0) {
  if constexpr (kMaj == kK)
    return hopper::wgmma_desc<kSwizzle>(tile + r0 * kSliceBytes, 8 * kSwizzle,
                                        8 * kSwizzle);
  else
    return hopper::wgmma_desc<kSwizzle>(tile + (r0 / kSlab) * kSlabBytes,
                                        kSlabBytes, 8 * kSwizzle);
}
template <int kMaj>
__host__ __device__ constexpr uint32_t k_step_bytes() {
  return kMaj == kK ? 32 : 16 * kSwizzle;
}

template <int BN, int kMajA, int kMajB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 256)
    hopper::wgmma_ss_m64n256k16<kMajA, kMajB>(d, da, db, 1);
  else
    hopper::wgmma_ss_m64n128k16<kMajA, kMajB>(d, da, db, 1);
}
template <int BN, int kMajA, int kMajB>
__device__ __forceinline__ void wgmma_ss(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(kMajA == kK && kMajB == kK, "int8 wgmma reads K-major only");
  if constexpr (BN == 256)
    hopper::wgmma_s8_m64n256k32(d, da, db, 1);
  else
    hopper::wgmma_s8_m64n128k32(d, da, db, 1);
}

// The slice's 4 k steps (32 bytes of K each) of one product on a stage's A
// and B tiles.
template <int BN, int kMajA, int kMajB, typename Acc>
__device__ __forceinline__ void slice_products(Acc (&acc)[BN / 2],
                                               const uint8_t* a,
                                               const uint8_t* b, int c) {
  const uint64_t da = tile_desc<kMajA>(a, 64 * c);
  const uint64_t db = tile_desc<kMajB>(b, 0);
#pragma unroll
  for (int kk = 0; kk < kSliceBytes / 32; ++kk)
    wgmma_ss<BN, kMajA, kMajB>(
        acc, hopper::desc_advance(da, kk * k_step_bytes<kMajA>()),
        hopper::desc_advance(db, kk * k_step_bytes<kMajB>()));
}

template <int BN, class Fm, class Epi>
__global__ __launch_bounds__(kThreads, (Config<BN, Fm::kDual>::kBlocksPerSM)) void gemm_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap a2map,
    const __grid_constant__ CUtensorMap b2map, const typename Epi::Args args,
    int k, int kslices) {
  using namespace hopper;
  using R = Ring<BN, Fm::kDual>;
  constexpr int S = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  Tiles<BN, Fm::kDual>& sm = *reinterpret_cast<Tiles<BN, Fm::kDual>*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  using Acc = typename Fm::Acc;
  constexpr int kSK = slice_k<Fm>();
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kBM;
  const int ktiles = (k + kSK - 1) / kSK;
  const int kt0 = blockIdx.z * kslices;
  const int nk = min(ktiles, kt0 + kslices) - kt0;  // >= 1 (the plan's split)
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
      if constexpr (Fm::kDual) {
        prefetch_tensor_map(&a2map);
        prefetch_tensor_map(&b2map);
      }
      for (int i = 0; i < nk; ++i) {
        const int st = i % S, kt = kt0 + i;
        uint8_t* stage = sm.ring[st];
        mbar_wait(&sm.empty[st], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], R::kStage);
        load_tile<Fm::kMajA, kBM, kSK>(stage, &amap, &sm.full[st], kt, m0);
        if constexpr (Fm::kPairB) {  // a rows, then gate rows, BN / 2 each
          const int c0 = n0 / 2, inner = gridDim.x * (BN / 2);
          load_tile<kK, BN / 2, kSK>(stage + R::kA, &bmap, &sm.full[st], kt,
                                     c0);
          load_tile<kK, BN / 2, kSK>(stage + R::kA + BN / 2 * kSliceBytes,
                                     &bmap, &sm.full[st], kt, inner + c0);
        } else {
          load_tile<Fm::kMajB, BN, kSK>(stage + R::kA, &bmap, &sm.full[st], kt,
                                        n0);
        }
        if constexpr (Fm::kDual) {
          load_tile<Fm::kMajA2, kBM>(stage + R::kA + R::kB, &a2map,
                                     &sm.full[st], kt, m0);
          load_tile<Fm::kMajB2, BN>(stage + 2 * R::kA + R::kB, &b2map,
                                    &sm.full[st], kt, n0);
        }
      }
    }
    return;
  }

  const int c = warp / 4;  // consumer warpgroup: rows 64c.. of the block

  Acc acc[BN / 2];
  float acc2[Fm::kDual ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  if constexpr (Fm::kDual) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc2[i] = 0.f;
  }

  for (int i = 0; i < nk; ++i) {
    const int st = i % S;
    mbar_wait(&sm.full[st], (i / S) & 1);
    const uint8_t* stage = sm.ring[st];
    wgmma_fence();
    slice_products<BN, Fm::kMajA, Fm::kMajB>(acc, stage, stage + R::kA, c);
    if constexpr (Fm::kDual)
      slice_products<BN, Fm::kMajA2, Fm::kMajB2>(
          acc2, stage + R::kA + R::kB, stage + 2 * R::kA + R::kB, c);
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products have completed
    if (i > 0 && lane == 0) mbar_arrive(&sm.empty[(i - 1) % S]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (Fm::kDual) fence_regs(acc2);

  // Both warpgroups' products have completed and no load is in flight: the
  // ring is free for the epilogue's staging.
  named_barrier_sync(1, 256);
  uint8_t* ring = &sm.ring[0][0];
  if constexpr (Fm::kDual)
    Epi::template run<BN>(acc, acc2, args, ring, m0 + 64 * c, n0, c);
  else
    Epi::template run<BN>(acc, args, ring, m0 + 64 * c, n0, c);
}

template <int BN, class Fm, class Epi>
cudaError_t launch(const CUtensorMap (&maps)[4], const typename Epi::Args& args,
                   int k, int kslices, dim3 grid, int64_t smem,
                   cudaStream_t s) {
  static int64_t smem_set = 0;  // the attribute, set once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<BN, Fm, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  gemm_kernel<BN, Fm, Epi><<<grid, kThreads, (size_t)smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], args, k, kslices);
  return cudaGetLastError();
}

// A plan's operand map (6 values: dims innermost first, row bytes, box,
// majorness) describes operand (rows, K) of majorness kMaj with tiles of
// `rows_box` rows and K slices of `slice` elements.
__host__ inline bool map_fits(const int64_t* p, int kMaj, int64_t rows,
                              int64_t k, int64_t rows_box, int slice) {
  if (p[5] != kMaj) return false;
  if (kMaj == kK)
    return p[0] == k && p[1] == rows && p[3] == slice && p[4] == rows_box;
  return p[0] == rows && p[1] == k && p[3] == kSlab && p[4] == kBK;
}

template <class Fm>
__host__ inline bool encode_map(CUtensorMap* map, const void* base,
                                const int64_t* p) {
  return hopper::encode_map_2d(
      map, Fm::kS8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      base, p, p[2], (int)p[3], (int)p[4], kSwizzle);
}

// The plan (kPlanValues int64, ops/gemm_sm90.py's GemmPlan) of a product
// (M, N, K) with C's row stride ldc: A's map (dims in elements, row bytes,
// box: one slice of K by the tile's rows for a K-major operand,
// majorness), B's, the swizzle bytes, the grid (N tiles, M tiles, K
// splits), the threads, the dynamic shared memory, BN, ldc, the K slices
// of a split.
// A paired-column plan's B map has boxes of BN / 2 rows, N is a multiple
// of BN and C is N / 2 wide.
template <int BN, class Fm>
__host__ inline bool plan_fits(const int64_t* p, int kMajA, int kMajB, int m,
                               int n, int k, int ldc) {
  constexpr int kSK = slice_k<Fm>();
  const int64_t ktiles = (k + kSK - 1) / kSK, splits = p[15], ks = p[20];
  constexpr int kPair = Fm::kPairB;
  if (kPair && n % BN != 0) return false;
  return map_fits(p, kMajA, m, k, kBM, kSK) &&
         map_fits(p + 6, kMajB, n, k, BN >> kPair, kSK) &&
         p[12] == kSwizzle && p[13] == (n + BN - 1) / BN &&
         p[14] == (m + kBM - 1) / kBM && splits >= 1 && ks >= 1 &&
         (splits - 1) * ks < ktiles && splits * ks >= ktiles &&
         p[16] == kThreads && p[17] >= (int64_t)smem_bytes<BN, Fm::kDual>() &&
         p[17] <= 232448 && p[18] == BN && p[19] == ldc && n % 8 == 0 &&
         ldc % 8 == 0 && ldc >= (n >> kPair);
}

// One product (or a dual one: p2 the second pair's plan, whose grid, split,
// tile width and shared memory must equal p's) from its plan, at one of the
// tile widths kBNs. A plan that does not describe this product, or whose
// maps cuTensorMapEncodeTiled refuses, is an invalid value; nothing is
// launched.
template <class Fm, class Epi, int... kBNs>
cudaError_t gemm_from_plan(const int64_t* p, const int64_t* p2, const void* A,
                           const void* B, const void* A2, const void* B2,
                           const typename Epi::Args& args, int m, int n, int k,
                           int ldc, cudaStream_t s) {
  if (p == nullptr || m <= 0 || (Fm::kDual && p2 == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  const auto one = [&](auto bn_tag) {
    constexpr int BN = decltype(bn_tag)::value;
    if (p[18] != BN) return false;
    if (!plan_fits<BN, Fm>(p, Fm::kMajA, Fm::kMajB, m, n, k, ldc)) return true;
    if constexpr (Fm::kDual) {
      if (!plan_fits<BN, Fm>(p2, Fm::kMajA2, Fm::kMajB2, m, n, k, ldc)) return true;
      for (int i = 12; i < kPlanValues; ++i)
        if (p2[i] != p[i]) return true;
    }
    CUtensorMap maps[4];
    if (!encode_map<Fm>(&maps[0], A, p) || !encode_map<Fm>(&maps[1], B, p + 6))
      return true;
    if constexpr (Fm::kDual) {
      if (!encode_map<Fm>(&maps[2], A2, p2) || !encode_map<Fm>(&maps[3], B2, p2 + 6))
        return true;
    } else {
      maps[2] = maps[0];
      maps[3] = maps[1];
    }
    const dim3 grid((unsigned)p[13], (unsigned)p[14], (unsigned)p[15]);
    err = launch<BN, Fm, Epi>(maps, args, k, (int)p[20], grid, p[17], s);
    return true;
  };
  (one(std::integral_constant<int, kBNs>{}) || ...);
  return err;
}

// An fp32 product of a plan (StoreF32) into out, through the partial planes
// `part` (splits x m x n) when the plan splits K.
template <class Fm, int... kBNs>
cudaError_t gemm_f32_from_plan(const int64_t* p, const void* A, const void* B,
                               float* out, float* part, int m, int n, int k,
                               int ldc, cudaStream_t s) {
  const int splits = p == nullptr ? 0 : (int)p[15];
  if (splits > 1 && (part == nullptr || n % 4 != 0))
    return cudaErrorInvalidValue;
  const StoreF32::Args args{splits > 1 ? part : out, m, n, splits > 1 ? n : ldc,
                            (int64_t)m * n};
  cudaError_t err = gemm_from_plan<Fm, StoreF32, kBNs...>(
      p, nullptr, A, B, nullptr, nullptr, args, m, n, k, splits > 1 ? n : ldc,
      s);
  if (err != cudaSuccess || splits <= 1) return err;
  const int64_t quads = (int64_t)m * n / 4;
  sum_splits_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(
      part, out, m, n, ldc, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sm90
