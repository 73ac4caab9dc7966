// Nearest codebook entry: idx[i] = argmin_j (|e_j|^2 - 2 z_i . e_j).
//
// Replaces attention_models_tpu/ops/codebook.py::_nn_kernel (entry
// nearest_codes). The |z_i|^2 term is constant per token and dropped, as
// there. Distances are fp32; ties go to the first (lowest) index, as
// torch.argmin and the TPU kernel's strict '<' across chunks do.
//
// Bound on the H100: operations. At the main path's 8192 tokens x 8192 codes
// x 32 dims the dots are 4.3 GFLOP against 1 MB of operands: 4.3 us at the
// bf16 tensor-core peak, 64 us at the CUDA cores' 67 TFLOP/s fp32 peak (an
// exact fp32 dot has no tensor-core form that keeps its bits: TF32, 3xTF32
// and DMMA move distances by more than an ulp, and the golden index path
// holds the parent's bits). In bf16 the argmin itself is the larger cost:
// 67 M (min, argmin) updates at four instructions each are ~9 us of issue
// on the CUDA cores, twice the products' time.
//
// A call is two launches. The design
// follows from the dtype and the width (design_of); the host plan
// (ops/codebook.py::codes_plan) cuts the codebook into grid.y slices of
// `split` codes (a multiple of kChunk), so that 8192 tokens (64 blocks of
// 128) fill the card:
//   1. codes_prep_kernel: |e|^2 once per code in the parent's order (a warp
//      a code, lanes over the dims, then warp_sum), the token tiles'
//      tickets zeroed, and for fp32 the codebook transposed, (d, k) with
//      rows ldt = k rounded up to 4 apart, so the tiles below read 16-byte
//      pieces of code columns;
//   2. the argmin of each (token tile, slice), launched as a programmatic
//      dependent of the prep pass (its prologue and z's tile overlap the
//      pass; it waits before reading what the pass writes): a running (min,
//      argmin) per token over the slice in ascending code order with a
//      strict '<', then, with more than one slice, the last block of each
//      token tile to finish (an atomic ticket) combines the slices' pairs
//      in ascending slice order with a strict '<':
//      - bf16, widths 8, 16, 32 and 64 (nearest_codes_wgmma_kernel): the
//        dots z . codes^T on wgmma (m64n128k16, fp32 sums of exact bf16
//        products). 128 token rows a block, two consumer warpgroups of 64
//        and one producer warp, the ring protocol of csrc/gemm_sm90.cuh
//        (full / empty mbarriers, a stage back to the producer when its
//        epilogue is done), two blocks an SM. z's tile is loaded once by
//        TMA and stays; the slice streams through a ring of 4 stages, each
//        a chunk of 128 codes and its 128 |e|^2 values. A tile row is
//        box_bytes(D) bytes: the width in bf16, at least one wgmma k step
//        (32 bytes), with the swizzle of that span (32, 64 or 128 bytes),
//        so width 32 takes 64-byte rows and two k steps, not the header's
//        128-byte slice with four (0.894 of its time, bench_codebook.py
//        variants). The epilogue (ArgminRows) walks the chunk's registers
//        with column offsets as immediates: an FFMA, a compare and two
//        selects a value;
//      - fp32, widths 8, 16, 32 and 64 (nearest_codes_tiles_kernel): exact
//        FMA dots on register tiles laid out as csrc/gemm.cuh's
//        reg_product: 128 tokens x 128 codes a chunk, 256 threads of 8 x 8
//        accumulators fed by 16-byte shared loads, z's tile ([dim][row])
//        staged once, the chunks ([dim][code], from the transposed copy)
//        double-buffered by cp.async, two blocks an SM. Each dot sums its
//        products with fmaf in ascending width order from 0 and each
//        distance is esq - 2 dot, as the parent kernel did, so every
//        distance, and so every index, keeps the parent's bits;
//      - any other width, either dtype (nearest_codes_any_kernel, the
//        first design, in 32-wide steps through shared memory, 512-code
//        slices; no prep pass, and its second launch is combine_kernel,
//        one thread a token): every dot in ascending width order, |e|^2
//        summed in order by one thread. It keeps its own combine: the
//        last-block combine in its tail took its registers from 95 to 150
//        (three blocks an SM, not five) and its time at width 20 from 0.26
//        to 0.37 ms; capped at five blocks it spilled and stayed at
//        0.38-0.40 (NVIDIA H100 80GB HBM3, 700 W; bench_codebook.py turns).
// The tie rule. Each thread keeps a running pair per row (and, in bf16, per
// column parity: two chains a row) over its columns in ascending order
// with a strict '<', so each chain holds the first lowest of its columns.
// The chains, then the threads that share a row (bf16: the quad,
// __shfl_xor 1, 2; fp32: the 16 threads of a tile row, xor 1..8), combine
// under the lexicographic (dist, index) minimum, which does not depend on
// the order of the combine; -0.0 and +0.0 compare equal there, as under
// '<'. So every design gives the first lowest index, torch.argmin's, and a
// repeat call the same bits. The slices combine in slice order, not by a
// 64-bit atomicMin on (dist bits, index) keys: those need an initialised
// key array, the -0.0 mapping and a pass to the int32 indices after them.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTokens = 128;  // rows of z a block (every design)
constexpr int kChunk = 128;   // codes a chunk of the new designs
constexpr int kSlice = 32;    // width step and codes per step of the any-width kernel

// The lexicographic (dist, index) order: (d, i) before (bd, bi).
__device__ __forceinline__ bool lex_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// The first lowest pair over the lanes of one row group: `span` lanes
// (xor 1 .. span / 2).
template <int kSpan>
__device__ __forceinline__ void lex_min_lanes(float& d, int& i) {
#pragma unroll
  for (int o = 1; o < kSpan; o <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (lex_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// A row's pair: the index itself when one slice covers the codebook, else
// the slice's (min, argmin) for the combine.
__device__ __forceinline__ void put_pair(float* part_d, int* part_i, int* out,
                                         int row, float d, int i) {
  if (gridDim.y == 1) {
    out[row] = i;
  } else {
    part_d[(int64_t)row * gridDim.y + blockIdx.y] = d;
    part_i[(int64_t)row * gridDim.y + blockIdx.y] = i;
  }
}

// Programmatic dependent launch: the argmin kernel is launched while the
// prep pass runs (its prologue overlaps it) and waits here, before it
// reads what the prep pass writes; the prep pass lets it launch at once. A
// kernel launched without the attribute passes both at once.
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// With more than one slice: the last of a token tile's gridDim.y blocks to
// finish (a ticket a tile, zeroed by the prep pass) combines the slices'
// pairs of the tile's rows in ascending slice order with a strict '<', so
// the first lowest index wins whatever order the blocks ran in. `sync` is
// a barrier over the `threads` threads that call it.
template <class Sync>
__device__ __forceinline__ void combine_last(const float* part_d,
                                             const int* part_i, int* out,
                                             int* tickets, int n, int m0,
                                             int tid, int threads, Sync sync) {
  __shared__ int last;
  if (gridDim.y == 1) return;
  __threadfence();  // this thread's pairs, before the ticket
  sync();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == (int)gridDim.y - 1;
  sync();
  if (!last) return;
  __threadfence();  // the other blocks' pairs, after their tickets
  const int slices = gridDim.y;
  for (int row = m0 + tid; row < min(n, m0 + kTokens); row += threads) {
    const float* pd = part_d + (int64_t)row * slices;
    const int* pi = part_i + (int64_t)row * slices;
    float best = __ldcg(pd);
    int best_idx = __ldcg(pi);
    for (int sl = 1; sl < slices; ++sl) {
      const float v = __ldcg(pd + sl);
      if (v < best) {
        best = v;
        best_idx = __ldcg(pi + sl);
      }
    }
    out[row] = best_idx;
  }
}

// -- 1. |e|^2 and the transposed fp32 codebook --------------------------------

constexpr int kPrepCodes = 32;  // codes a block

template <typename T, int D>
__global__ __launch_bounds__(256) void codes_prep_kernel(
    const T* __restrict__ codes, float* __restrict__ esq, float* __restrict__ ct,
    int* __restrict__ tickets, int k, int ldt, int tiles) {
  __shared__ float cs[kPrepCodes][D + 1];  // padded: no bank conflicts
  allow_dependents();
  const int j0 = blockIdx.x * kPrepCodes, tid = threadIdx.x;
  if (blockIdx.x == 0)
    for (int i = tid; i < tiles; i += 256) tickets[i] = 0;
  for (int i = tid; i < kPrepCodes * D; i += 256) {
    const int j = i / D, c = i % D;
    cs[j][c] = j0 + j < k ? to_f32<T>(codes[(int64_t)(j0 + j) * D + c]) : 0.f;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int j = warp; j < kPrepCodes; j += 8) {
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s = fmaf(cs[j][c], cs[j][c], s);
    s = warp_sum(s);
    if (lane == 0 && j0 + j < k) esq[j0 + j] = s;
  }
  if (ct != nullptr) {
    for (int i = tid; i < kPrepCodes * D; i += 256) {
      const int c = i / kPrepCodes, j = i % kPrepCodes;
      if (j0 + j < k) ct[(int64_t)c * ldt + j0 + j] = cs[j][c];
    }
  }
}

// -- 2a. bf16: the dots on wgmma ------------------------------------------------

constexpr int kWgThreads = 288;  // two consumer warpgroups + one producer warp
constexpr int kWgBlocks = 2;     // blocks an SM (at most 112 registers)
constexpr int kStages = 4;

// Bytes of a tile row (a token's or a code's dims, zero-filled past D by
// TMA) and the swizzle span of its tiles.
template <int D>
__host__ __device__ constexpr int box_bytes() {
  return 2 * D < 32 ? 32 : 2 * D;
}

// Shared memory; every tile starts on a 1024-byte boundary (the base is
// aligned by hand): z's tile, then the ring, each stage a chunk of codes
// and its |e|^2 (512 bytes, padded to 1024).
template <int D>
struct WgTiles {
  static constexpr int kRow = box_bytes<D>();
  static constexpr uint32_t kA = kTokens * kRow, kB = kChunk * kRow;
  static constexpr uint32_t kStage = kB + 1024;
  uint8_t a[kA];
  uint8_t ring[kStages][kStage];
  uint64_t a_full, full[kStages], empty[kStages];
};

// The argmin epilogue of a warpgroup's 64 x kChunk accumulators, in the
// style of csrc/gemm_sm90.cuh's epilogues (w = warp in the warpgroup,
// g = lane / 4, t = lane % 4): acc[4i + e] = z . e of row 16w + g + 8(e / 2)
// and column 8i + 2t + (e % 2) of the chunk. dist = esq[col] - 2 acc, and a
// running (min, argmin) for each of the thread's two rows and each column
// parity, walked in ascending column order with a strict '<'. It runs per
// chunk and keeps its pairs across the slice; finish() combines them.
struct ArgminRows {
  float best[2][2];
  int idx[2][2];

  __device__ __forceinline__ explicit ArgminRows(int first) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        best[r][p] = INFINITY;
        idx[r][p] = first;
      }
  }
  // The chunk's pairs first hold the column's offset from c0 + 2t, an
  // immediate (8i + p), so a value costs an FFMA, a compare and two
  // selects; they join the running pairs with a strict '<' at the end.
  // Columns at and past `valid` (a ragged last chunk: TMA's zeros) are out.
  template <bool kMasked>
  __device__ __forceinline__ void run(const float (&acc)[kChunk / 2],
                                      const float* esq, int c0, int valid) {
    const int t = threadIdx.x % 4;
    float cb[2][2];
    int ci[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        cb[r][p] = INFINITY;
        ci[r][p] = 0;
      }
#pragma unroll
    for (int i = 0; i < kChunk / 8; ++i) {
      const float2 e2 = *reinterpret_cast<const float2*>(esq + 8 * i + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, p = e & 1;
        // esq - 2 acc, rounded once (2 acc is exact)
        float dist = fmaf(-2.f, acc[4 * i + e], p ? e2.y : e2.x);
        if (kMasked && 8 * i + 2 * t + p >= valid) dist = INFINITY;
        if (dist < cb[r][p]) {
          cb[r][p] = dist;
          ci[r][p] = 8 * i + p;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        if (cb[r][p] < best[r][p]) {
          best[r][p] = cb[r][p];
          idx[r][p] = c0 + 2 * t + ci[r][p];
        }
  }
  // Row r's first lowest pair over the thread's two chains, then the quad.
  __device__ __forceinline__ void finish(float (&d)[2], int (&ix)[2]) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      d[r] = best[r][0];
      ix[r] = idx[r][0];
      if (lex_less(best[r][1], idx[r][1], d[r], ix[r])) {
        d[r] = best[r][1];
        ix[r] = idx[r][1];
      }
      lex_min_lanes<4>(d[r], ix[r]);
    }
  }
};

template <int D>
__global__ __launch_bounds__(kWgThreads, kWgBlocks) void nearest_codes_wgmma_kernel(
    const __grid_constant__ CUtensorMap zmap,
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap emap, float* __restrict__ part_d,
    int* __restrict__ part_i, int* __restrict__ out, int* __restrict__ tickets,
    int n, int k, int split) {
  using namespace hopper;
  using Tl = WgTiles<D>;
  constexpr int kSw = Tl::kRow, kSteps = kSw / 32;  // k steps of 16 bf16
  extern __shared__ uint8_t smem_raw[];
  Tl& sm = *reinterpret_cast<Tl*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int m0 = blockIdx.x * kTokens;
  const int cb = blockIdx.y * split, ce = min(k, cb + split);
  const int nc = (ce - cb + kChunk - 1) / kChunk;  // >= 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.a_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      prefetch_tensor_map(&zmap);
      prefetch_tensor_map(&cmap);
      prefetch_tensor_map(&emap);
      mbar_expect_tx(&sm.a_full, Tl::kA);
      tma_load_2d(sm.a, &zmap, &sm.a_full, 0, m0);
      wait_prerequisite();  // |e|^2
      for (int i = 0; i < nc; ++i) {
        const int st = i % kStages, c0 = cb + i * kChunk;
        mbar_wait(&sm.empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], Tl::kB + kChunk * 4);
        tma_load_2d(sm.ring[st], &cmap, &sm.full[st], 0, c0);
        tma_load_2d(sm.ring[st] + Tl::kB, &emap, &sm.full[st], c0, 0);
      }
    }
    return;
  }

  // Consumer warpgroup c: rows 64c.. of the block. Each chunk's products,
  // then its epilogue; the two blocks on an SM keep its tensor cores and
  // issue slots busy while a warpgroup waits (a second accumulator set for
  // the next chunk would cost one block an SM: slower on the H100).
  const int c = warp / 4;
  mbar_wait(&sm.a_full, 0);
  const uint64_t da = wgmma_desc<kSw>(sm.a + 64 * c * kSw, 8 * kSw, 8 * kSw);
  ArgminRows am(cb);
  float acc[kChunk / 2];
  for (int i = 0; i < nc; ++i) {
    const int st = i % kStages, c0 = cb + i * kChunk;
    mbar_wait(&sm.full[st], (i / kStages) & 1);
    const uint64_t db = wgmma_desc<kSw>(sm.ring[st], 8 * kSw, 8 * kSw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
      wgmma_ss_m64n128k16<0, 0>(acc, desc_advance(da, kk * 32),
                                desc_advance(db, kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    const float* es = reinterpret_cast<const float*>(sm.ring[st] + Tl::kB);
    if (ce - c0 >= kChunk)
      am.run<false>(acc, es, c0, kChunk);
    else
      am.run<true>(acc, es, c0, ce - c0);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // codes and |e|^2 are read
  }

  float d[2];
  int ix[2];
  am.finish(d, ix);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 64 * c + 16 * (warp % 4) + lane / 4 + 8 * r;
      if (row < n) put_pair(part_d, part_i, out, row, d[r], ix[r]);
    }
  }
  wait_prerequisite();  // the tickets (the producer thread waited already)
  combine_last(part_d, part_i, out, tickets, n, m0, threadIdx.x, 256,
               [] { hopper::named_barrier_sync(1, 256); });
}

// `kernel` launched after the prep pass with programmatic stream
// serialization (see wait_prerequisite), dynamic shared memory `smem` (its
// attribute set at the first launch).
template <class Kernel, class... Args>
cudaError_t launch_dependent(Kernel kernel, bool& smem_set, dim3 grid,
                             int threads, size_t smem, cudaStream_t s,
                             Args... args) {
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int D>
cudaError_t launch_wgmma(const __nv_bfloat16* z, const __nv_bfloat16* codes,
                         const float* esq, float* part_d, int* part_i,
                         int* out, int* tickets, int n, int k, int split,
                         cudaStream_t s) {
  constexpr int kRow = box_bytes<D>();
  CUtensorMap zmap, cmap, emap;
  const int64_t zd[2] = {D, n}, cd[2] = {D, k}, ed[2] = {k, 1};
  if (!hopper::encode_map_2d(&zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z, zd,
                             2 * D, kRow / 2, kTokens, kRow) ||
      !hopper::encode_map_2d(&cmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, codes,
                             cd, 2 * D, kRow / 2, kChunk, kRow) ||
      !hopper::encode_map_2d(&emap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, esq, ed,
                             (4 * (int64_t)k + 15) / 16 * 16, kChunk, 1, 0))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  return launch_dependent(
      nearest_codes_wgmma_kernel<D>, smem_set,
      dim3((n + kTokens - 1) / kTokens, (k + split - 1) / split), kWgThreads,
      sizeof(WgTiles<D>) + 1024, s, zmap, cmap, emap, part_d, part_i, out,
      tickets, n, k, split);
}

// -- 2b. fp32: exact FMA dots on register tiles ---------------------------------

constexpr int kTileThreads = 256;  // 16 x 16: (tx, ty) = (tid % 16, tid / 16)
constexpr int kTileBlocks = 2;     // blocks an SM (at most 128 registers)

template <int D>
struct TileSmem {
  float z[D][kTokens + 4];       // z's tile [dim][row]; 16 bytes of padding
  float c[2][D][kChunk + 4];     // two chunks of codes [dim][code]
  float e[2][kChunk];            // their |e|^2
};

// Thread (tx, ty) holds rows 4 ty + r (r < 4) and 60 + 4 ty + r (r >= 4)
// against columns 4 tx + j (j < 4) and 60 + 4 tx + j (j >= 4) of the chunk.
template <int D>
__global__ __launch_bounds__(kTileThreads, kTileBlocks) void nearest_codes_tiles_kernel(
    const float* __restrict__ z, const float* __restrict__ ct,
    const float* __restrict__ esq, int ldt, float* __restrict__ part_d,
    int* __restrict__ part_i, int* __restrict__ out, int* __restrict__ tickets,
    int n, int k, int split) {
  extern __shared__ float4 smem_f4[];
  TileSmem<D>& sm = *reinterpret_cast<TileSmem<D>*>(smem_f4);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kTokens;
  const int cb = blockIdx.y * split, ce = min(k, cb + split);
  const int nc = (ce - cb + kChunk - 1) / kChunk;  // >= 1

  // chunk i: D rows of 32 16-byte pieces of the transposed codebook and 32
  // pieces of |e|^2 into buffer i % 2 (zeros past the slice; a piece that
  // straddles k reads ldt's padding, masked in the epilogue)
  const auto load = [&](int i) {
    const int c0 = cb + i * kChunk, buf = i & 1;
    // D / 8 pieces a thread; at width 64 a rolled loop (unrolled, its
    // addresses spilled registers)
#pragma unroll(D < 64 ? D / 8 : 1)
    for (int u = 0; u < D / 8; ++u) {
      const int p = tid + u * kTileThreads;
      const int dim = p / (kChunk / 4), col = 4 * (p % (kChunk / 4));
      const bool live = c0 + col < ce;
      cp_async16(&sm.c[buf][dim][col],
                 live ? ct + (int64_t)dim * ldt + c0 + col : ct, live);
    }
    if (tid < kChunk / 4) {
      const bool live = c0 + 4 * tid < ce;
      cp_async16(&sm.e[buf][4 * tid], live ? esq + c0 + 4 * tid : esq, live);
    }
    cp_async_commit();
  };

  for (int i = tid; i < kTokens * D; i += kTileThreads) {
    const int r = i / D, dim = i % D;
    sm.z[dim][r] = m0 + r < n ? z[(int64_t)(m0 + r) * D + dim] : 0.f;
  }
  wait_prerequisite();  // |e|^2, the transposed codebook, the tickets
  load(0);
  float best[8];
  int bidx[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best[r] = INFINITY;
    bidx[r] = cb;
  }

  for (int i = 0; i < nc; ++i) {
    if (i + 1 < nc) {
      load(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk i (and z's tile) has landed for every thread
    const int buf = i & 1;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    // the width unrolled whole up to 32, 8 at a time at 64 (a whole 64
    // leaves no register spare; bench_codebook.py variants times both)
#pragma unroll(D <= 32 ? D : 8)
    for (int dim = 0; dim < D; ++dim) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.z[dim][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.z[dim][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.c[buf][dim][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.c[buf][dim][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
    // the argmin epilogue: each row's columns in ascending order
    const int c0 = cb + i * kChunk, valid = ce - c0;
    const float4 e0 = *reinterpret_cast<const float4*>(&sm.e[buf][4 * tx]);
    const float4 e1 = *reinterpret_cast<const float4*>(&sm.e[buf][64 + 4 * tx]);
    const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? 4 * tx + j : 60 + 4 * tx + j;
      const bool live = valid >= kChunk || col < valid;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        // esq - 2 dot, rounded once (2 dot is exact), as the parent's
        const float dist = live ? fmaf(-2.f, acc[r][j], ev[j]) : INFINITY;
        if (dist < best[r]) {
          best[r] = dist;
          bidx[r] = c0 + col;
        }
      }
    }
    __syncthreads();  // buffer i % 2 is read; load(i + 2) may overwrite it
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    lex_min_lanes<16>(best[r], bidx[r]);
    const int row = m0 + (r < 4 ? 4 * ty + r : 60 + 4 * ty + r);
    if (tx == 0 && row < n) put_pair(part_d, part_i, out, row, best[r], bidx[r]);
  }
  combine_last(part_d, part_i, out, tickets, n, m0, tid, kTileThreads,
               [] { __syncthreads(); });
}

template <int D>
cudaError_t launch_tiles(const float* z, const float* ct, const float* esq,
                         int ldt, float* part_d, int* part_i, int* out,
                         int* tickets, int n, int k, int split,
                         cudaStream_t s) {
  static bool smem_set = false;
  return launch_dependent(
      nearest_codes_tiles_kernel<D>, smem_set,
      dim3((n + kTokens - 1) / kTokens, (k + split - 1) / split),
      kTileThreads, sizeof(TileSmem<D>), s, z, ct, esq, ldt, part_d, part_i,
      out, tickets, n, k, split);
}

// -- 2c. any other width --------------------------------------------------------

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

// -- 3. the any-width kernel's slices ------------------------------------------

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

// The designs (ops/codebook.py names them to size the work scratch).
enum Design { kAny = 0, kWgmma = 1, kTiles = 2 };

__host__ inline int design_of(int dtype, int d) {
  if (d != 8 && d != 16 && d != 32 && d != 64) return kAny;
  return dtype == AMT_BF16 ? kWgmma : kTiles;
}

template <int D>
cudaError_t launch_prep(const void* codes, int dtype, float* esq, float* ct,
                        int* tickets, int k, int ldt, int tiles,
                        cudaStream_t s) {
  const unsigned blocks = (k + kPrepCodes - 1) / kPrepCodes;
  if (dtype == AMT_BF16)
    codes_prep_kernel<__nv_bfloat16, D><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(codes), esq, ct, tickets, k, ldt,
        tiles);
  else
    codes_prep_kernel<float, D><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(codes), esq, ct, tickets, k, ldt, tiles);
  return cudaGetLastError();
}

// work: |e|^2 (ldt = k rounded up to 4), the token tiles' tickets (rounded
// up to 4), then for fp32 the transposed codebook (d rows of ldt).
template <int D>
cudaError_t launch_new(const void* z, const void* codes, float* part_d,
                       int* part_i, int* out, int n, int k, int split,
                       int dtype, float* work, cudaStream_t s) {
  const int ldt = (k + 3) / 4 * 4, tiles = (n + kTokens - 1) / kTokens;
  float* esq = work;
  int* tickets = reinterpret_cast<int*>(work + ldt);
  float* ct = dtype == AMT_F32 ? work + ldt + (tiles + 3) / 4 * 4 : nullptr;
  cudaError_t err = launch_prep<D>(codes, dtype, esq, ct, tickets, k, ldt,
                                   tiles, s);
  if (err != cudaSuccess) return err;
  if (dtype == AMT_BF16)
    return launch_wgmma<D>(static_cast<const __nv_bfloat16*>(z),
                           static_cast<const __nv_bfloat16*>(codes), esq,
                           part_d, part_i, out, tickets, n, k, split, s);
  return launch_tiles<D>(static_cast<const float*>(z), ct, esq, ldt, part_d,
                         part_i, out, tickets, n, k, split, s);
}

}  // namespace

// split is a multiple of 128. part_d / part_i: n * ceil(k / split) entries
// each (widths 8, 16, 32 and 64 read them only for more than one slice).
// work (those widths): |e|^2 in k rounded up to 4 fp32 entries, a ticket a
// 128-token tile rounded up to 4, then for fp32 the transposed codebook, d
// rows of the first length; any other width takes none.
AMT_EXPORT int amt_nearest_codes(const void* z, const void* codes, void* part_d,
                                 void* part_i, void* out, int n, int k, int d,
                                 int split, int dtype, void* work,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* w = static_cast<float*>(work);
  int* o = static_cast<int*>(out);
  if (n == 0) return cudaSuccess;
  if (k <= 0 || d <= 0 || split <= 0 || split % kChunk != 0 ||
      (dtype != AMT_BF16 && dtype != AMT_F32))
    return cudaErrorInvalidValue;
  const int design = design_of(dtype, d), slices = (k + split - 1) / split;
  if ((slices > 1 || design == kAny) && (pd == nullptr || pi == nullptr))
    return cudaErrorInvalidValue;
  if (design != kAny) {
    if (w == nullptr) return cudaErrorInvalidValue;
    switch (d) {
      case 8:
        return launch_new<8>(z, codes, pd, pi, o, n, k, split, dtype, w, s);
      case 16:
        return launch_new<16>(z, codes, pd, pi, o, n, k, split, dtype, w, s);
      case 32:
        return launch_new<32>(z, codes, pd, pi, o, n, k, split, dtype, w, s);
      default:
        return launch_new<64>(z, codes, pd, pi, o, n, k, split, dtype, w, s);
    }
  }
  const dim3 grid((n + kTokens - 1) / kTokens, slices);
  if (dtype == AMT_BF16)
    nearest_codes_any_kernel<__nv_bfloat16><<<grid, kTokens, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z),
        static_cast<const __nv_bfloat16*>(codes), pd, pi, n, k, d, split);
  else
    nearest_codes_any_kernel<float><<<grid, kTokens, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(codes), pd, pi,
        n, k, d, split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(pd, pi, o, n, slices);
  return cudaGetLastError();
}
