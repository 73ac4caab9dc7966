"""Host plans of csrc/gemm_sm90.cuh's TMA/wgmma tile product.

Everything a launch of the tile product needs is decided here, on the host,
from the operands' shapes, strides and alignment: each operand's rank-2
tensor map (dims, row pitch, box, K-major or MN-major), the grid, the split
of K into ordered partials, the tile width and the shared memory. A view TMA
cannot take raises a ValueError naming it before anything is launched; the
C side checks the plan against the product, encodes the maps and launches.
Kernels 7 and 2 (``ops/ffn.py::mlp_plan``), 6 and 8 (``ops/ffn.py::
ln_mlp_bwd_plan`` and ``mlp_bwd_plan``), 11 and 12 (``ops/ffn.py::ffn_plan``
and ``ffn_bwd_plan``), 13 and 14 (``ops/xent.py::xent_fwd_plan`` and
``xent_bwd_plan``) build their plans from these pieces, and kernels 19, 20
and 21 (``ops/quant.py::q8_plan``, ``q8wide_plan`` and ``ln_mlp_q8_plan``)
too. The GEGLU products of kernels 11, 19 and 20 read W1 in the
paired-column form: its B tile is two boxes of ``bn / 2`` rows, W1's "a"
rows and the matching "gate" rows. The down-projections of kernels 19 and
20, kernel 19's up-projection and both of kernel 21's products run the
product's int8 form: a K slice is 128 bytes whatever the type, so its boxes
are 128 int8 of K where bf16 ones are 64, over the same ring.

``tile_product`` runs one product in any operand form with an fp32 result
(``csrc/tile_product.cu``): the tile product for bf16 operands, csrc/
gemm.cuh's register-tiled FMA product (``gemm_f32``) for fp32 ones;
``tile_product_s8`` the int8 form with its dequantising epilogue. No model
path calls them: chip_smoke.py holds each form against ``torch.matmul`` (the
int8 form against ``torch._int_mm``) of the same views on the card.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from attention_models_torch.ops import _build
from attention_models_torch.ops.dispatch import check_tensor, is_kernel_path

# csrc/gemm_sm90.cuh: 128 rows of C a block, K slices of 128 bytes (one
# swizzle row: 64 bf16 or 128 int8), two consumer warpgroups and a producer
# warp; an MN-major tile (bf16 only) is loaded as (64 MN, 64 K) boxes
GEMM_ROWS, GEMM_K, GEMM_THREADS, GEMM_SWIZZLE = 128, 64, 288, 128
SLAB = 64
# ring depth of each (tile width, dual product) the header instantiates
GEMM_STAGES = {(128, False): 3, (256, False): 4, (128, True): 3}
ROW_ALIGN = 32        # elements: scratch and staged rows start 64-byte aligned
SM_COUNT = 132        # the H100 SXM's SMs: the split aims at two blocks each
MAX_K_SPLITS = 8      # ranges of K at most (each adds an fp32 partial plane)
K_MAJOR, MN_MAJOR = 0, 1


@dataclass(frozen=True)
class TileMap:
    """A rank-2 TMA tensor map over a row-major bf16 or int8 matrix:
    ``dims`` (inner, outer) in elements, innermost first ((K, rows) for a
    K-major operand, (rows, K) for an MN-major one); ``stride`` the bytes
    between outer rows; ``box`` the tile one load brings ((one 128-byte
    slice of K, tile rows) K-major, (SLAB, GEMM_K) MN-major); ``major``
    K_MAJOR or MN_MAJOR."""
    dims: tuple[int, int]
    stride: int
    box: tuple[int, int]
    major: int

    def values(self) -> list[int]:
        return [*self.dims, self.stride, *self.box, self.major]


@dataclass(frozen=True)
class GemmPlan:
    """One tile product C (M, N) = epilogue(A B^T): the maps of A (M, K) and
    B (N, K), the swizzle (bytes), the grid (N tiles of ``bn``, M tiles of
    GEMM_ROWS, K splits), the threads, the dynamic shared memory, the tile
    width ``bn``, the row stride ``ldc`` (elements) of what the epilogue
    writes (a split's fp32 partial planes: N) and the K slices of a
    split."""
    a: TileMap
    b: TileMap
    swizzle: int
    grid: tuple[int, int, int]
    threads: int
    smem: int
    bn: int
    ldc: int
    kslices: int

    def values(self) -> list[int]:
        """The 21 int64 values csrc/gemm_sm90.cuh's gemm_from_plan reads
        (kPlanValues)."""
        return [*self.a.values(), *self.b.values(), self.swizzle,
                *self.grid, self.threads, self.smem, self.bn, self.ldc,
                self.kslices]

    @property
    def splits(self) -> int:
        return self.grid[2]


@dataclass(frozen=True)
class PlanArray:
    """Products' plans as the one int64 array a C entry reads (built
    once)."""
    plans: tuple[GemmPlan, ...]
    _c: object = field(default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        vals = [v for p in self.plans for v in p.values()]
        object.__setattr__(self, "_c", (ctypes.c_int64 * len(vals))(*vals))

    def c_array(self):
        return self._c


def gemm_smem_bytes(bn: int, dual: bool = False) -> int:
    """Dynamic shared memory of the tile product at tile width ``bn`` (the
    same for bf16 and int8 operands: a slice is 128 bytes a row): the
    struct Tiles (GEMM_STAGES stages of an A and a B tile, two of each in a
    dual product, a full and an empty mbarrier a stage) plus 1024 bytes of
    alignment slack."""
    stages = GEMM_STAGES[(bn, dual)]
    stage = (1 + dual) * (GEMM_ROWS + bn) * GEMM_SWIZZLE
    return stages * stage + 16 * stages + 1024


def row_pitch(k: int) -> int:
    """Elements a row of k elements takes when rows start 64-byte
    aligned."""
    return -(-k // ROW_ALIGN) * ROW_ALIGN


def meta(name: str, t: torch.Tensor) -> tuple:
    """What a plan reads of a tensor: its name, shape, element strides, item
    size and address modulo 16."""
    return (name, tuple(t.shape), tuple(t.stride()), t.element_size(),
            t.data_ptr() % 16)


def scratch_meta(name: str, rows: int, cols: int, pitch: int,
                 item: int = 2) -> tuple:
    """The meta of a (rows, cols) scratch of ``item``-byte elements (bf16
    unless given) at ``pitch`` elements a row (allocated 16-byte
    aligned)."""
    return (name, (rows, cols), (pitch, 1), item, 0)


def slice_k(item: int) -> int:
    """Elements of K in one 128-byte slice of a K-major operand."""
    return GEMM_SWIZZLE // item


def tile_map(m: tuple, major: int, rows_box: int,
             what: str = "mlp kernel") -> TileMap:
    """The map of a matrix given its meta: for a K-major operand the
    (rows, K) matrix itself, for an MN-major one the (K, rows) matrix; a
    view TMA cannot take raises, naming why."""
    name, (outer, inner), stride, item, misalign = m
    if misalign:
        raise ValueError(f"{what}: {name} starts at an address that is "
                         f"not 16-byte aligned, which TMA cannot load")
    if stride[1] != 1:
        raise ValueError(f"{what}: {name} needs a contiguous last "
                         f"dimension for TMA (strides {stride})")
    row_bytes = stride[0] * item
    if row_bytes <= 0 or row_bytes % 16:
        raise ValueError(f"{what}: {name}'s row stride of {row_bytes} "
                         f"bytes is not a positive multiple of 16, which TMA "
                         f"cannot take")
    if item == 1 and major != K_MAJOR:
        raise ValueError(f"{what}: {name} is int8, which wgmma reads "
                         f"K-major only")
    box = ((slice_k(item), rows_box) if major == K_MAJOR
           else (SLAB, GEMM_K))
    return TileMap((inner, outer), row_bytes, box, major)


def split_k(tiles: int, k: int, slice_: int = GEMM_K) -> tuple[int, int]:
    """(splits, slices a split) for a product of ``tiles`` output tiles over
    K: as many ranges of K as one wave of two blocks an SM holds (a block
    past the wave would run alone at its end), each a whole number of
    ``slice_``-element slices, at most MAX_K_SPLITS; 1 where the tiles give
    all but a 32nd of the SMs a block of their own (chosen in turns on the
    H100, bench_bwd.py: kernel 8's 128 tiles over K 4160 read faster whole
    than in two ranges, kernel 6's 96 over K 8192 slower)."""
    ktiles = -(-k // slice_)
    want = (1 if 32 * tiles >= 31 * SM_COUNT
            else min(max(1, 2 * SM_COUNT // tiles), ktiles, MAX_K_SPLITS))
    kslices = -(-ktiles // want)
    return -(-ktiles // kslices), kslices


def gemm_plan(a: tuple, a_major: int, b: tuple, b_major: int, bn: int,
              ldc: int, *, split: bool = False, dual: bool = False,
              paired: bool = False, what: str = "mlp kernel") -> GemmPlan:
    """The plan of C = A B^T for the operands' metas and majorness, at tile
    width ``bn``; ``split``: K split into ordered fp32 partials as
    ``split_k`` chooses (the epilogue then writes (M, N) planes: ``ldc`` is
    N); ``dual``: the shared memory of a dual product's ring; ``paired``:
    the paired-column form (B K-major, N a multiple of ``bn``, its boxes
    ``bn / 2`` rows; C is N / 2 wide). Both operands bf16, or both int8
    (K-major, K slices of 128)."""
    if a[3] != b[3]:
        raise ValueError(f"{what}: {a[0]} and {b[0]} differ in item size")
    am = tile_map(a, a_major, GEMM_ROWS, what)
    bm = tile_map(b, b_major, bn // 2 if paired else bn, what)
    m = am.dims[1] if a_major == K_MAJOR else am.dims[0]
    k = am.dims[0] if a_major == K_MAJOR else am.dims[1]
    n = bm.dims[1] if b_major == K_MAJOR else bm.dims[0]
    kb = bm.dims[0] if b_major == K_MAJOR else bm.dims[1]
    if k != kb:
        raise ValueError(f"{what}: {a[0]} and {b[0]} disagree on K "
                         f"({k} and {kb})")
    if paired and (b_major != K_MAJOR or n % bn):
        raise ValueError(f"{what}: the paired-column product needs {b[0]} "
                         f"K-major with its {n} rows a multiple of the tile "
                         f"width {bn}")
    grid_n, grid_m = -(-n // bn), -(-m // GEMM_ROWS)
    sk = slice_k(a[3])
    splits, kslices = (split_k(grid_n * grid_m, k, sk) if split
                       else (1, -(-k // sk)))
    return GemmPlan(am, bm, swizzle=GEMM_SWIZZLE,
                    grid=(grid_n, grid_m, splits), threads=GEMM_THREADS,
                    smem=gemm_smem_bytes(bn, dual), bn=bn,
                    ldc=n if splits > 1 else ldc, kslices=kslices)


# -- one product in any form (the forms' check on the card) -----------------

FORMS = {(K_MAJOR, K_MAJOR): 0, (K_MAJOR, MN_MAJOR): 1,
         (MN_MAJOR, K_MAJOR): 2, (MN_MAJOR, MN_MAJOR): 3}


def _operand(t: torch.Tensor, major: int) -> torch.Tensor:
    """The (rows, K) operand a stored matrix is read as."""
    return t if major == K_MAJOR else t.T


def tile_product(a: torch.Tensor, a_major: int, b: torch.Tensor,
                 b_major: int, *, split: bool = False,
                 tile_width: int = 0) -> torch.Tensor:
    """C (M, N) = A B^T in fp32, with A (M, K) stored as ``a`` itself
    (K_MAJOR) or as its transpose ``a`` (K, M) (MN_MAJOR), and B (N, K)
    likewise. For CUDA tensors: bf16 operands through the tile product
    (``split``: K in ordered partials), fp32 operands through gemm_f32
    (``tile_width`` 128 or 64, 0 its own choice); for CPU tensors a plain
    fp32 matmul."""
    am, bmat = _operand(a, a_major), _operand(b, b_major)
    if not is_kernel_path(a):
        return am.float() @ bmat.float().T
    for name, t in (("a", a), ("b", b)):
        check_tensor(t, name, (torch.bfloat16, torch.float32), 2, a.device)
    if b.dtype != a.dtype:
        raise TypeError("tile product: a and b must share a dtype")
    m, n, k = am.shape[0], bmat.shape[0], am.shape[1]
    if a.dtype == torch.float32:
        if m % 8 or n % 8 or k % 8 or any(t.data_ptr() % 16
                                          for t in (a, b)):
            raise ValueError("tile product (fp32): M, N and K must be "
                             "multiples of 8 and the operands 16-byte "
                             "aligned")
        out = torch.empty(m, n, dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            _build.launch("amt_tile_product_f32", a.data_ptr(), a.stride(0),
                          b.data_ptr(), b.stride(0), out.data_ptr(), m, n, k,
                          FORMS[(a_major, b_major)], tile_width,
                          _build.stream_of(a))
        tile_product.launches += 1
        return out
    plan = gemm_plan(meta("a", a), a_major, meta("b", b), b_major, 128, n,
                     split=split, what="tile product")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    part = (torch.empty(plan.splits, m, n, dtype=torch.float32,
                        device=a.device) if plan.splits > 1 else None)
    arr = PlanArray((plan,))
    with torch.cuda.device(a.device):
        _build.launch("amt_tile_product", arr.c_array(), a.data_ptr(),
                      b.data_ptr(), out.data_ptr(),
                      None if part is None else part.data_ptr(), m, n, k, n,
                      FORMS[(a_major, b_major)], _build.stream_of(a))
    tile_product.launches += 1
    return out


tile_product.launches = 0


def tile_product_s8(a: torch.Tensor, b: torch.Tensor,
                    s_row: torch.Tensor | None = None,
                    s_col: torch.Tensor | None = None) -> torch.Tensor:
    """C (M, N) = (float(A B^T) * s_row) * s_col in fp32 for int8 A (M, K)
    and B (N, K), both K-major (unit scales when not given): the tile
    product's int8 form for CUDA tensors (int32 sums, exact), the plain
    float64 product for CPU tensors."""
    m, n = a.shape[0], b.shape[0]
    if s_row is None:
        s_row = torch.ones(m, dtype=torch.float32, device=a.device)
    if s_col is None:
        s_col = torch.ones(n, dtype=torch.float32, device=a.device)
    if not is_kernel_path(a):
        acc = (a.double() @ b.double().T).float()
        return acc * s_row[:, None] * s_col
    for name, t in (("a", a), ("b", b)):
        check_tensor(t, name, (torch.int8,), 2, a.device)
    for name, t in (("s_row", s_row), ("s_col", s_col)):
        check_tensor(t, name, (torch.float32,), 1, a.device)
    if n % 8:
        raise ValueError("tile product (int8): N must be a multiple of 8")
    plan = gemm_plan(meta("a", a), K_MAJOR, meta("b", b), K_MAJOR, 128, n,
                     what="tile product (int8)")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    arr = PlanArray((plan,))
    with torch.cuda.device(a.device):
        _build.launch("amt_tile_product_s8", arr.c_array(), a.data_ptr(),
                      b.data_ptr(), s_row.data_ptr(), s_col.data_ptr(),
                      out.data_ptr(), m, n, a.shape[1], n,
                      _build.stream_of(a))
    tile_product_s8.launches += 1
    return out


tile_product_s8.launches = 0
