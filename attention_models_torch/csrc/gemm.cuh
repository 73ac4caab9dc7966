// Products and block reductions shared by the GEGLU FFN, head, MLP,
// LayerNorm and W8A8 kernels (csrc/ffn.cu, ffn_bwd.cu, xent.cu, mlp_bwd.cu,
// ln_mlp_bwd.cu, layernorm.cu, quant.cu, tile_product.cu):
//   - gemm_f32: C (M x N) = A B over K in fp32, with A an (M, K) view and B
//     an (N, K) view of device memory, each in one of two layouts:
//       kK: element (r, k) at p[r * ld + k]  (contiguous along k: x, W1
//           rows)
//       kR: element (r, k) at p[k * ld + r]  (contiguous along r: a (K, R)
//           array read transposed, as dy^T in dW2 = dy^T y)
//     so one kernel serves x W^T, dy W and the A^T B weight gradients
//     (kernels 11, 12 and 14 in fp32; reg_product also under kernel 11's
//     GEGLU product and kernels 13 and 14's fp32 logits): the
//     register-tiled FMA product below, 128 x 128 (or 128 x 64) tiles of
//     8 x 8 (8 x 4) outputs a thread. Rows and columns past M, N and K are
//     zero-filled, so K adds nothing there. Requirements: M, N, K and
//     every ld multiples of 8, operands 16-byte aligned. The bf16 and int8
//     products run on csrc/gemm_sm90.cuh's TMA/wgmma tile product;
//   - a row held in registers over one block, block sums in a fixed order,
//     and the ordered column sums of cross-block partials (colsum).
#pragma once

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Layout { kK = 0, kR = 1 };

constexpr int kThreads = 256;  // threads of a row pass's block

// ---- fp32: register-tiled exact FMA products (gemm_f32) -------------------
// 128 x kTN output tiles (kTN 128, or 64 where 128-wide tiles would not
// fill one wave), 256 threads as 16 x 16: thread (tx, ty) owns
// rows 4 ty + i and 64 + 4 ty + i (i < 4) and columns 4 tx + j (+ 64) of
// the tile, 8 x 8 (or 8 x 4) fp32 accumulators. K runs in slices of 8
// through a ring of kRStages stages in shared memory laid out [k][row],
// loads two slices ahead of the products, so a thread reads its
// rows and columns of a k step as 16-byte loads (the A pair broadcast over
// a warp's 16 tx). Every load of the next slice is a cp.async issued before
// the current slice's products, so no register is held across them (loads
// into registers were sunk below the products by the compiler, leaving a
// slice's whole load latency in front of each barrier). A kR operand's
// slice is an (8 k, rows) block of device memory as it lies: cp.async
// copies it into the stage not being read. A kK operand's slice is
// transposed on the way: each thread's 16-byte piece lands in its own
// staging slot and, after the products, goes to the stage as four
// [k][row] words. One barrier a slice. Each output is the sum over
// k = 0 .. K-1 in order by fmaf: exact fp32, and a repeat call gives the
// same bits.
// Requirements: K, N and ldc multiples of 8 (N % 4 for the 16-byte stores),
// operands and C 16-byte aligned.
constexpr int kRM = 128, kRK = 8, kRThreads = 256, kRStages = 3;

template <int ROWS>
struct RSlice {
  float v[kRK][ROWS + 4];  // [k][row]; 16 bytes of padding: no bank conflicts
};
template <int kTN>
struct RTiles {
  RSlice<kRM> a[kRStages];
  RSlice<kTN> b[kRStages];
  float4 slot[2][2][kRThreads];  // [slice parity][A, B]: kK pieces in flight
};

// A thread's 16-byte piece of every K slice of one operand tile (ROWS rows):
// kK, a row-major (rows, K) matrix: row p / 2, k 4 (p % 2); kR, a (K, rows)
// one: k p / (ROWS / 4), rows 4 (p % (ROWS / 4)) ... Threads p >= 2 ROWS own
// no piece; a piece past the operand's rows is zeros.
template <int L, int ROWS>
struct Piece {
  const float* src;  // the piece in slice 0
  int64_t step;      // elements from one slice's piece to the next's
  int r, k;          // its place in the slice
  bool owns, live;

  // src_row: the operand row the piece reads (kK; for kR the first of its
  // four), valid: that row exists
  __device__ __forceinline__ Piece(const float* p, int ld, int src_row,
                                   bool valid, int tid) {
    owns = tid < 2 * ROWS;
    if (L == kK) {
      r = tid / 2;
      k = (tid % 2) * 4;
      step = kRK;
      src = p + (int64_t)src_row * ld + k;
    } else {
      k = tid / (ROWS / 4);
      r = (tid % (ROWS / 4)) * 4;
      step = (int64_t)kRK * ld;
      src = p + (int64_t)k * ld + src_row;
    }
    live = owns && valid;
    if (!live) src = p;
  }
  // the tile row this thread's piece lands in (kK) or starts at (kR)
  static __device__ __forceinline__ int tile_row(int tid) {
    return L == kK ? tid / 2 : (tid % (ROWS / 4)) * 4;
  }
  // start slice kt by cp.async: a kK piece into this thread's staging
  // slot, a kR piece into its place in the stage (zeros past the rows)
  __device__ __forceinline__ void issue(int kt, float4* slot,
                                        RSlice<ROWS>& st) const {
    if (!owns) return;
    if (L == kK)
      cp_async16(slot, src + kt * step, live);
    else
      cp_async16(&st.v[k][r], src + kt * step, live);
  }
  // finish slice kt once the copies have landed (kK: the slot, transposed)
  __device__ __forceinline__ void land(const float4* slot,
                                       RSlice<ROWS>& st) const {
    if (L == kK && owns) {
      const float4 v = *slot;
      st.v[k][r] = v.x;
      st.v[k + 1][r] = v.y;
      st.v[k + 2][r] = v.z;
      st.v[k + 3][r] = v.w;
    }
  }
};

// acc[i][4 cg + j] += sum over K of A[row i] B[col 4 tx + 64 cg + j], the
// rows of i < 4 at 4 ty + i, of i >= 4 at 64 + 4 ty + i - 4 (in order over
// K, one fmaf a term). K a multiple of kRK.
template <int kTN, int LA, int LB>
__device__ __forceinline__ void reg_product(const Piece<LA, kRM>& pa,
                                            const Piece<LB, kTN>& pb, int K,
                                            RTiles<kTN>& sm,
                                            float (&acc)[8][kTN / 16]) {
  constexpr int kCN = kTN / 64;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kCN; ++j) acc[i][j] = 0.f;
  const int KT = K / kRK;
  // slice s: stage s % kRStages, kK slots of parity s % 2; one commit group
  // a slice (empty past K), so wait_group<1> means "slice s + 1 landed"
  const auto issue = [&](int s) {
    if (s < KT) {
      pa.issue(s, &sm.slot[s & 1][0][tid], sm.a[s % kRStages]);
      pb.issue(s, &sm.slot[s & 1][1][tid], sm.b[s % kRStages]);
    }
    cp_async_commit();
  };
  const auto land = [&](int s) {
    if (s < KT) {
      pa.land(&sm.slot[s & 1][0][tid], sm.a[s % kRStages]);
      pb.land(&sm.slot[s & 1][1][tid], sm.b[s % kRStages]);
    }
  };
  issue(0);
  issue(1);
  cp_async_wait<1>();
  land(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt % kRStages;
    // slice kt + 2's loads fly under slice kt's and kt + 1's products; its
    // stage was last read by slice kt - 1's, before the last barrier
    issue(kt + 2);
    const RSlice<kRM>& as = sm.a[cur];
    const RSlice<kTN>& bs = sm.b[cur];
#pragma unroll
    for (int k = 0; k < kRK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as.v[k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as.v[k][64 + 4 * ty]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[4 * kCN];
#pragma unroll
      for (int cg = 0; cg < kCN; ++cg) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&bs.v[k][64 * cg + 4 * tx]);
        b[4 * cg] = bv.x;
        b[4 * cg + 1] = bv.y;
        b[4 * cg + 2] = bv.z;
        b[4 * cg + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kCN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    cp_async_wait<1>();  // slice kt + 1 has landed
    land(kt + 1);
    __syncthreads();
  }
}

// The operand row of tile row `tr` for a plain product: r0 + tr.
template <int L, int ROWS>
__device__ __forceinline__ Piece<L, ROWS> plain_piece(const float* p, int ld,
                                                      int R, int r0) {
  const int row = r0 + Piece<L, ROWS>::tile_row(threadIdx.x);
  return Piece<L, ROWS>(p, ld, row, row < R, threadIdx.x);
}

// Block z sums K range [z kchunk, min(K, (z + 1) kchunk)) into C + z zstride.
template <int kTN, int LA, int LB>
__global__ __launch_bounds__(kRThreads, 2) void gemm_f32_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    float* __restrict__ C, int ldc, int M, int N, int K, int kchunk,
    int64_t zstride) {
  __shared__ __align__(16) RTiles<kTN> sm;
  const int m0 = blockIdx.y * kRM, n0 = blockIdx.x * kTN;
  const int k0 = blockIdx.z * kchunk;
  A += LA == kK ? k0 : (int64_t)k0 * lda;
  B += LB == kK ? k0 : (int64_t)k0 * ldb;
  C += blockIdx.z * zstride;
  float acc[8][kTN / 16];
  reg_product<kTN>(plain_piece<LA, kRM>(A, lda, M, m0),
                   plain_piece<LB, kTN>(B, ldb, N, n0), min(kchunk, K - k0),
                   sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (row >= M) continue;
#pragma unroll
    for (int cg = 0; cg < kTN / 64; ++cg) {
      const int col = n0 + 64 * cg + 4 * tx;
      if (col < N)
        *reinterpret_cast<float4*>(C + (int64_t)row * ldc + col) =
            make_float4(acc[i][4 * cg], acc[i][4 * cg + 1], acc[i][4 * cg + 2],
                        acc[i][4 * cg + 3]);
    }
  }
}

// The SMs of the current device, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Waves of two blocks an SM that `blocks` take.
inline int64_t f32_waves(int64_t blocks) {
  const int64_t slots = 2 * (int64_t)sm_count();
  return (blocks + slots - 1) / slots;
}

// The tile width of an unsplit fp32 product: 64 where the 128-wide tiles
// fill less than one wave of two blocks an SM (twice the blocks keep more
// SMs busy), else 128 (a 64-wide tile does half the work at a lower rate;
// chosen in turns on the H100, bench_ffn.py).
inline int f32_tile_width(int M, int N) {
  const int64_t tiles = (int64_t)((M + kRM - 1) / kRM) * ((N + 127) / 128);
  return tiles < 2 * (int64_t)sm_count() ? 64 : 128;
}

// The ranges K is split into (1 to 4, each at least 256 deep and a
// multiple of kRK) where the 128-wide tiles fill their last wave poorly:
// the count whose waves per range are fewest, while splits x M x N fp32
// partials fit `cap` elements (ties to fewer).
inline int f32_splits(int M, int N, int K, int64_t cap) {
  const int64_t tiles = (int64_t)((M + kRM - 1) / kRM) * ((N + 127) / 128);
  int best = 1;
  for (int s = 2; s <= 4; ++s) {
    if (K / s < 256 || (int64_t)s * M * N > cap) break;
    if (f32_waves(tiles * s) * best < f32_waves(tiles * best) * s) best = s;
  }
  return best;
}

// C (M, N; rows ldc apart) = A B in fp32 for kK / kR views A (M, K) and
// B (N, K); tn: the tile width (128 or 64; 0: f32_tile_width's choice);
// splits > 1: K in that many ordered ranges (128-wide tiles), their fp32
// partials in part (splits x M x N), summed in order into C.
template <int LA, int LB>
cudaError_t gemm_f32_tn(const float* A, int lda, const float* B, int ldb,
                        float* C, int ldc, int M, int N, int K, int tn,
                        cudaStream_t s, int splits = 1, float* part = nullptr) {
  if (M <= 0 || N <= 0 || K % kRK != 0 || N % 4 != 0 || ldc % 4 != 0 ||
      splits < 1 || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (splits > 1) tn = 128;
  if (tn == 0) tn = f32_tile_width(M, N);
  const int kchunk = (K / kRK + splits - 1) / splits * kRK;
  splits = (K + kchunk - 1) / kchunk;
  float* out = splits > 1 ? part : C;
  const int ldo = splits > 1 ? N : ldc;
  const int64_t zstride = (int64_t)M * N;
  const unsigned gy = (M + kRM - 1) / kRM;
  if (tn == 128)
    gemm_f32_kernel<128, LA, LB><<<dim3((N + 127) / 128, gy, splits), kRThreads, 0, s>>>(
        A, lda, B, ldb, out, ldo, M, N, K, kchunk, zstride);
  else if (tn == 64)
    gemm_f32_kernel<64, LA, LB><<<dim3((N + 63) / 64, gy, splits), kRThreads, 0, s>>>(
        A, lda, B, ldb, out, ldo, M, N, K, kchunk, zstride);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t quads = zstride / 4;
  sum_splits_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, s>>>(part, C, M, N, ldc,
                                                                  splits);
  return cudaGetLastError();
}

template <int LA, int LB>
cudaError_t gemm_f32(const float* A, int lda, const float* B, int ldb, float* C,
                     int ldc, int M, int N, int K, cudaStream_t s) {
  return gemm_f32_tn<LA, LB>(A, lda, B, ldb, C, ldc, M, N, K, 0, s);
}

// gemm_f32 with K split as f32_splits chooses for `cap` elements of fp32
// partials at part (the GEGLU FFN's products, csrc/ffn*.cu).
template <int LA, int LB>
cudaError_t gemm_f32_split(const float* A, int lda, const float* B, int ldb, float* C,
                           int ldc, int M, int N, int K, float* part, int64_t cap,
                           cudaStream_t s) {
  const int splits = part == nullptr ? 1 : f32_splits(M, N, K, cap);
  return gemm_f32_tn<LA, LB>(A, lda, B, ldb, C, ldc, M, N, K, 0, s, splits, part);
}

// ---- a row held in registers (csrc/ffn.cu's and csrc/ffn_bwd.cu's row
// passes) ----------------------------------------------------------------------
// A row of `width` fp32 values (width % 4 == 0) spread over one block of
// row_threads(width, NV) threads: thread t owns the 16-byte pieces
// t + blockDim.x u (u < NV) below width / 4, so each 16-byte load of a warp
// is one contiguous 512-byte run and every value is read once.
constexpr int kRowsNV4 = 4096;  // widths a row_threads(width, 4) block holds
constexpr int kRowsMax = 8192;  // ... and with 8 pieces a thread (a wider
                                // row is walked in chunks of this width)
__host__ __device__ inline int row_threads(int width, int nv) {
  return 32 * ((width / 4 + 32 * nv - 1) / (32 * nv));
}

// N sums over the block (blockDim.x a multiple of 32), the same in every
// thread, in a fixed order: each warp by shuffles, then its warps in order;
// red: 32 N floats of shared memory.
template <int N>
__device__ __forceinline__ void block_sums(float (&v)[N], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = warp_sum(v[j]);
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[warp * N + j] = v[j];
  }
  __syncthreads();
  const int warps = blockDim.x / 32;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += red[w * N + j];
    v[j] = s;
  }
}

// The sum over the block of one value (red: a float a warp).
__device__ __forceinline__ float block_sum(float v, float* red) {
  float s[1] = {v};
  block_sums(s, red);
  return s[0];
}

// Four values into p[0..3] in T: one 16-byte store (fp32) or 8-byte (bf16).
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(a, b), pack_bf16x2(c, d));
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
