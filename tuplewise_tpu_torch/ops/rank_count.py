"""Launchers of the sort-and-count kernels of ``csrc/rank_count.cu``.

Three bodies have a sort-and-count route on the card, behind their
usual wrappers (which check the tensors and count the launches):

* ``pair_kernels.pair_sum`` with the auc body (kernel 1, unmasked):
  :func:`auc_twice_counts` returns the int64 ``2 * wins + ties`` of each
  problem, which the wrapper halves in float64.
* ``triplet_kernels.batched_masked_pair_sum`` with the indicator or the
  hinge combine (kernel 5): :func:`triplet_sums` returns the float64
  per-problem sums; the hinge's as (margin + A) * sum(mk) - sum(mk * B)
  over the prefix of the sorted tile where the body is positive.

The second operand (b, or B's rows) is cut into tiles of
:func:`tile_size` values (at most ``HINGE_MAX_TILE`` for the hinge, whose
two float64 prefix sums must fit shared memory beside the tile); a block
sorts a tile (a block-wide radix sort) and the first operand's values
count it by binary search in shared memory (the tile in Eytzinger order)
with the body's own predicate on the float32 difference (the source's
header note gives the exactness and NaN rules). Nothing here falls
back: a failed build or launch raises. Nothing is built when the module
is imported.
"""

from __future__ import annotations

import ctypes

import torch

_SOURCE = "rank_count.cu"
# the compile-time constants of csrc/rank_count.cu (checked against the
# built library in load_library)
MAX_TILE, MIN_TILE, COUNT_CHUNK, HINGE_MAX_TILE = 16384, 2048, 8192, 8192
_MAX_GRID_YZ = 65535
_MAX_GRID_X = (1 << 31) - 1


def tile_size(n: int, max_tile: int = MAX_TILE) -> int:
    """Values of the second operand sorted by one block: n rounded up to
    a power of two, within [MIN_TILE, max_tile]."""
    return min(max_tile, max(MIN_TILE, 1 << max(0, int(n) - 1).bit_length()))


def load_library():
    """Build (at first use) and load the sort-and-count library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_rank_auc.argtypes = [p, p, p, p, ll, ll, i, i, p]
        lib.tw_rank_auc.restype = i
        lib.tw_rank_indicator.argtypes = [p, p, p, p, p, p, p, ll, ll, ll, ll,
                                          ctypes.c_float, i, p]
        lib.tw_rank_indicator.restype = i
        lib.tw_rank_hinge.argtypes = lib.tw_rank_indicator.argtypes
        lib.tw_rank_hinge.restype = i
        built = (lib.tw_rank_max_tile(), lib.tw_rank_min_tile(),
                 lib.tw_rank_count_chunk(), lib.tw_rank_hinge_max_tile())
        want = (MAX_TILE, MIN_TILE, COUNT_CHUNK, HINGE_MAX_TILE)
        if built != want:
            raise RuntimeError(f"{_SOURCE} was built with tiles {built}, "
                               f"the launcher expects {want}")
        lib._tw_typed = True
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} CUDA launch failed: cudaError {err}")


def auc_twice_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[W] int64: 2 * #{fl(a_i - b_j) > 0} + #{fl(a_i - b_j) == 0} per
    problem, for checked contiguous float32 CUDA tensors a [W, n1] and
    b [W, n2] (n1, n2, W > 0): one sort launch and one count launch."""
    W, n1 = a.shape
    n2 = b.shape[1]
    T = tile_size(n2)
    tiles = -(-n2 // T)
    chunks = -(-n1 // COUNT_CHUNK)
    if W > _MAX_GRID_YZ or tiles > _MAX_GRID_YZ or chunks > _MAX_GRID_X:
        raise ValueError(f"W={W}, n1={n1}, n2={n2} is beyond the CUDA grid "
                         f"of the auc count ({tiles} tiles of {T})")
    lib = load_library()
    sorted_b = torch.empty((W, tiles, T), dtype=torch.float32,
                           device=a.device)
    partials = torch.empty((W, tiles, chunks), dtype=torch.int64,
                           device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_rank_auc(a.data_ptr(), b.data_ptr(), sorted_b.data_ptr(),
                              partials.data_ptr(), n1, n2, W, T, stream)
    _raise_on(err, f"pair_sum[auc] sort-and-count (W={W}, n1={n1}, n2={n2}, "
                   f"tile {T})")
    return partials.sum(dim=(1, 2))


def triplet_sums(kind: str, A, B, mp, ip, ia, mk, margin: float, C: int):
    """[W] float64 per-problem sums of the ``kind`` ("indicator" or
    "hinge") combine (the contract of
    ``triplet_kernels.batched_masked_pair_sum``, NaN and infinities as the
    plain version gives them) for checked CUDA tensors with W, P, K > 0:
    one launch, one block a (problem, tile of B), the float64 partials of
    a problem summed in a fixed order."""
    W, P = A.shape
    K = B.shape[1]
    T = tile_size(K, MAX_TILE if kind == "indicator" else HINGE_MAX_TILE)
    tiles = -(-K // T)
    if W > _MAX_GRID_X or tiles > _MAX_GRID_YZ:
        raise ValueError(f"W={W}, P={P}, K={K} is beyond the CUDA grid of "
                         f"the {kind} count ({tiles} tiles of {T})")
    lib = load_library()
    launch = lib.tw_rank_indicator if kind == "indicator" else lib.tw_rank_hinge
    partials = torch.empty((W, tiles), dtype=torch.float64, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            A.data_ptr(), B.data_ptr(), mp.data_ptr(), ip.data_ptr(),
            ia.data_ptr(), mk.data_ptr(), partials.data_ptr(), P, K, W, C,
            margin, T, stream)
    _raise_on(err, f"batched_masked_pair_sum[triplet_{kind}] "
                   f"sort-and-count (W={W}, P={P}, K={K}, tile {T})")
    return partials.sum(dim=1)
