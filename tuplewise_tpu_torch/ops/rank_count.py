"""Launchers of the sort-and-count kernels of ``csrc/rank_count.cu``.

These wrappers and bodies have a sort-and-count route on the card,
behind the wrappers' usual checks and launch counts:

* ``pair_kernels.pair_sum`` with the auc body (kernel 1, unmasked):
  :func:`auc_twice_counts` returns the int64 ``2 * wins + ties`` of each
  problem, which the wrapper halves in float64, by one of two routes that
  :func:`auc_route` picks from the shape: "search" (below) where b fits
  one tile or a is too short to pay for its sort, else "merge": a's and
  b's keys sorted whole (tiles of 16384 sorted, then merged in
  ceil(log2(tiles)) passes) and counted by a merge of the two, each a_i
  adding #{b < a_i} + #{b <= a_i} by key, less the pairs of equal
  infinities. Each call adds one to
  ``obs.tracing.COUNTS["auc_route[<route>]"]``.
* ``pair_kernels.pair_sum`` with the hinge body (kernel 1, unmasked):
  :func:`hinge_pair_sums` returns the float64 pair sum of each problem,
  the hinge gradient route's loss alone (b's tiles sorted once with their
  suffix sums, each a searching every tile; no counts, no col pass).
* ``pair_kernels.masked_pair_sum`` with the auc or the hinge body
  (kernel 2): :func:`masked_pair_sums` returns the float64 weighted pair
  sum of each problem (b's tiles sorted once with their weights and the
  float64 suffix sums of the weights, and for the hinge of the weighted
  scores; each a searching every tile with the body's predicates and
  adding ma_i times its part).
* ``triplet_kernels.batched_masked_pair_sum`` with the indicator or the
  hinge combine (kernel 5): :func:`triplet_sums` returns the float64
  per-problem sums; the hinge's as (margin + A) * sum(mk) - sum(mk * B)
  over the prefix of the sorted tile where the body is positive.
* ``pair_grad_kernels.pair_loss_grad`` / ``pair_grad_sums`` with the
  hinge body (kernels 3-4): :func:`hinge_grad` returns the row and col
  sums of g' = -1{d < 1} as float32 of exact int32 counts, and the loss
  sum c (1 - a_i) + (sum of the suffix of the sorted b where fl(a_i - b)
  < 1) in float64. Both sides are cut into tiles of
  :func:`grad_tile_size` values (``GRAD_TILES``), sorted once; each
  value of one side searches every tile of the other.

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

from tuplewise_tpu_torch.obs.tracing import COUNTS

_SOURCE = "rank_count.cu"
# the compile-time constants of csrc/rank_count.cu (checked against the
# built library in load_library)
MAX_TILE, MIN_TILE, COUNT_CHUNK, HINGE_MAX_TILE = 16384, 2048, 8192, 8192
# the keys one merge block of the auc's merge route takes (a part of a
# merge path, in each merge pass and in the count)
MERGE_BLOCK = 4096
# the auc's routes: the search costs about n1 tiles(n2) tile searches, the
# merge about n1 + n2 keys sorted, merged and counted, so auc_route compares
# tile searches a key of a and b, n1 tiles(n2) / (n1 + n2), with this
# crossover. Measured (bench_torch_variants.py --auc, ms a call by CUDA
# events with the launches, the lesser of two turns, N(0, 1) scores, on an
# NVIDIA H100 80GB HBM3 at 700 W), search / merge at that many searches a
# key: W = 8: 6.6 (135000 x 540000) 0.315 / 0.353, 7.2 (560000 x 140000)
# 0.274 / 0.352, 8.0 (262144^2) 0.243 / 0.217, 12.8 (1048576 x 262144)
# 0.745 / 0.664, 15.4 (312500 x 1250000) 1.246 / 0.822, 38.5 (config 5's
# stop, 1250000^2) 4.046 / 1.278; W = 1 (launch-bound, noisier): 7.2 0.109
# / 0.139, 8.0 0.117 / 0.131, 12.8 0.153 / 0.151, 15.4 0.196 / 0.163, 38.5
# 0.548 / 0.250
MERGE_MIN_SEARCHES = 10
# the hinge gradient's tiles (csrc/rank_count.cu grad_sort_kernel): the
# smallest that holds a side, or the largest
GRAD_TILES = (256, 2048, 8192, 16384)
_MAX_GRID_YZ = 65535
_MAX_GRID_X = (1 << 31) - 1


def tile_size(n: int, max_tile: int = MAX_TILE) -> int:
    """Values of the second operand sorted by one block: n rounded up to
    a power of two, within [MIN_TILE, max_tile]."""
    return min(max_tile, max(MIN_TILE, 1 << max(0, int(n) - 1).bit_length()))


def grad_tile_size(n: int) -> int:
    """Values of one side of the hinge gradient sorted by one block: the
    smallest of ``GRAD_TILES`` that holds n, else the largest."""
    return next((t for t in GRAD_TILES if t >= n), GRAD_TILES[-1])


def masked_tile_size(n: int, hinge: bool) -> int:
    """Values of b sorted by one block of the masked pair sum: the
    smallest of ``GRAD_TILES`` that holds n, else the largest that fits
    (the hinge's at most ``HINGE_MAX_TILE``: its tile carries two float64
    suffix sums a value)."""
    T = grad_tile_size(n)
    return min(T, HINGE_MAX_TILE) if hinge else T


def load_library():
    """Build (at first use) and load the sort-and-count library."""
    from tuplewise_tpu_torch.ops import _build

    lib = _build.load(_SOURCE)
    if not getattr(lib, "_tw_typed", False):
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.tw_rank_auc.argtypes = [p, p, p, p, ll, ll, i, i, p]
        lib.tw_rank_auc.restype = i
        lib.tw_rank_auc_merge.argtypes = [p, p, p, p, p, ll, ll, i, p]
        lib.tw_rank_auc_merge.restype = i
        lib.tw_rank_indicator.argtypes = [p, p, p, p, p, p, p, ll, ll, ll, ll,
                                          ctypes.c_float, i, p]
        lib.tw_rank_indicator.restype = i
        lib.tw_rank_hinge.argtypes = lib.tw_rank_indicator.argtypes
        lib.tw_rank_hinge.restype = i
        lib.tw_rank_hinge_grad.argtypes = [p] * 13 + [ll, ll, i, i, i, i, p]
        lib.tw_rank_hinge_grad.restype = i
        lib.tw_rank_hinge_sum.argtypes = [p] * 7 + [ll, ll, i, i, p]
        lib.tw_rank_hinge_sum.restype = i
        lib.tw_rank_grad_chunk.argtypes = [i]
        lib.tw_rank_grad_chunk.restype = i
        lib.tw_rank_sum_chunk.argtypes = [i]
        lib.tw_rank_sum_chunk.restype = i
        lib.tw_rank_masked_sum.argtypes = [p] * 9 + [ll, ll, i, i, i, p]
        lib.tw_rank_masked_sum.restype = i
        built = (lib.tw_rank_max_tile(), lib.tw_rank_min_tile(),
                 lib.tw_rank_count_chunk(), lib.tw_rank_hinge_max_tile(),
                 lib.tw_rank_merge_block())
        want = (MAX_TILE, MIN_TILE, COUNT_CHUNK, HINGE_MAX_TILE,
                MERGE_BLOCK)
        if built != want or not all(map(lib.tw_rank_grad_chunk,
                                        GRAD_TILES)):
            raise RuntimeError(f"{_SOURCE} was built with tiles {built}, "
                               f"the launcher expects {want} and gradient "
                               f"tiles {GRAD_TILES}")
        lib._tw_typed = True
    return lib


def _carve(sizes, dtype, device):
    """One scratch tensor of sum(sizes) elements of dtype and the address
    of each part in order (the caller keeps the tensor alive while its
    kernels run)."""
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    at = [buf.data_ptr()]
    for size in sizes[:-1]:
        at.append(at[-1] + buf.element_size() * size)
    return buf, at


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} CUDA launch failed: cudaError {err}")


def auc_route(n1: int, n2: int) -> str:
    """The route of :func:`auc_twice_counts` for problems of n1 x n2:
    "merge" where the search route's tile searches, n1 ceil(n2 /
    MAX_TILE), number at least ``MERGE_MIN_SEARCHES`` a key of a and b,
    else "search": so b of one tile (n1 (log2(T) + 1) probes already), or
    an a too short to pay for its sort, keeps the search."""
    tiles = -(-n2 // MAX_TILE)
    if n1 * tiles >= MERGE_MIN_SEARCHES * (n1 + n2):
        return "merge"
    return "search"


def auc_twice_counts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[W] int64: 2 * #{fl(a_i - b_j) > 0} + #{fl(a_i - b_j) == 0} per
    problem, for checked contiguous float32 CUDA tensors a [W, n1] and
    b [W, n2] (n1, n2, W > 0), by the route :func:`auc_route` picks."""
    route = auc_route(a.shape[1], b.shape[1])
    COUNTS[f"auc_route[{route}]"] += 1
    return (_auc_merge if route == "merge" else _auc_search)(a, b)


def _auc_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The merge route: one sort launch (a's and b's tiles), ceil(log2(
    tiles)) merge launches and one count launch; two key buffers of W (n1
    + n2) uint32."""
    W, n1 = a.shape
    n2 = b.shape[1]
    parts = -(-(n1 + n2) // MERGE_BLOCK)
    if W > _MAX_GRID_YZ:
        raise ValueError(f"W={W}, n1={n1}, n2={n2} is beyond the CUDA grid "
                         f"of the auc merge route")
    lib = load_library()
    keys = torch.empty((2, W * (n1 + n2)), dtype=torch.int32,
                       device=a.device)
    partials = torch.empty((W, parts), dtype=torch.int64, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_rank_auc_merge(a.data_ptr(), b.data_ptr(),
                                    keys[0].data_ptr(), keys[1].data_ptr(),
                                    partials.data_ptr(), n1, n2, W, stream)
    _raise_on(err, f"pair_sum[auc] sort-and-merge (W={W}, n1={n1}, "
                   f"n2={n2})")
    return partials.sum(dim=1)


def _auc_search(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The search route: one sort launch (b's tiles) and one count
    launch."""
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


def hinge_grad(a: torch.Tensor, b: torch.Tensor, with_loss: bool):
    """(loss [W] float64 or None, row [W, n1], col [W, n2] float32) of the
    hinge body for checked contiguous float32 CUDA tensors a [W, n1] and
    b [W, n2] (n1, n2, W > 0): row_i = -#{j : fl(a_i - b_j) < 1}, col_j =
    -#{i : fl(a_i - b_j) < 1}, loss = sum of max(0, 1 - fl(a_i - b_j)),
    NaN and infinities as the plain version gives them. Two sorts, two
    count launches and one finishing launch, and two scratch buffers; the
    counts are integers, so row and col are the same with and without the
    loss, and repeat."""
    W, n1 = a.shape
    n2 = b.shape[1]
    Ta, Tb = grad_tile_size(n1), grad_tile_size(n2)
    ta, tb = -(-n1 // Ta), -(-n2 // Tb)
    if W > _MAX_GRID_YZ or max(ta, tb) > _MAX_GRID_YZ \
            or max(n1, n2) >= 1 << 31:
        raise ValueError(f"W={W}, n1={n1}, n2={n2} is beyond the CUDA grid "
                         f"of the hinge gradient ({ta} tiles of {Ta}, {tb} "
                         f"of {Tb})")
    lib = load_library()
    chunks = -(-n1 // lib.tw_rank_grad_chunk(Tb))
    dev = a.device
    # one int32 scratch carved in 4-byte words: the sorted tiles (float32)
    # and the tile infos first (16-byte aligned: tiles and infos are
    # multiples of 4 words), the counts last; one float64 scratch for the
    # suffix sums and the loss partials
    words, at = _carve((W * ta * Ta, W * tb * Tb, W * ta * 4, W * tb * 4,
                        W * n1, W * n2), torch.int32, dev)
    wide = (torch.empty(W * tb * (Tb + 1 + chunks), dtype=torch.float64,
                        device=dev) if with_loss else None)
    row = torch.empty(W, n1, dtype=torch.float32, device=dev)
    col = torch.empty(W, n2, dtype=torch.float32, device=dev)
    loss = torch.empty(W, dtype=torch.float64, device=dev) if with_loss \
        else None
    suffix = losspart = None
    if with_loss:
        suffix = wide.data_ptr()
        losspart = suffix + 8 * W * tb * (Tb + 1)
    sorted_a, sorted_b, info_a, info_b, counts_a, counts_b = at
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_rank_hinge_grad(
            a.data_ptr(), b.data_ptr(), sorted_a, sorted_b, suffix, info_a,
            info_b, counts_a, counts_b, losspart, row.data_ptr(),
            col.data_ptr(), None if loss is None else loss.data_ptr(), n1,
            n2, W, Ta, Tb, int(with_loss), stream)
    _raise_on(err, f"hinge gradient sort-and-search (W={W}, n1={n1}, "
                   f"n2={n2}, tiles {Ta} / {Tb})")
    return loss, row, col


def hinge_pair_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[W] float64 sums of max(0, 1 - fl(a_i - b_j)) over each problem's
    pairs, NaN and infinities as the plain version gives them, for checked
    contiguous float32 CUDA tensors a [W, n1] and b [W, n2] (n1, n2, W >
    0): b cut into tiles of :func:`grad_tile_size` values, sorted once
    with their float64 suffix sums; each a_i searches every tile with the
    body's float32 predicate and adds c (1 - a_i) + the suffix sum past
    the search. Three launches (sort, search, a fixed-order sum of the
    partials), so a call repeats bit for bit."""
    W, n1 = a.shape
    n2 = b.shape[1]
    T = grad_tile_size(n2)
    tiles = -(-n2 // T)
    if W > _MAX_GRID_YZ or tiles > _MAX_GRID_YZ or max(n1, n2) >= 1 << 31:
        raise ValueError(f"W={W}, n1={n1}, n2={n2} is beyond the CUDA grid "
                         f"of the hinge pair sum ({tiles} tiles of {T})")
    lib = load_library()
    chunks = -(-n1 // lib.tw_rank_sum_chunk(T))
    dev = a.device
    # one float64 scratch carved in 8-byte words: the sorted tiles (float32)
    # and the tile infos (int4) first, 16-byte aligned (T / 2 and 2 words
    # a tile), then the suffix sums and the partials
    wide, at = _carve((W * tiles * T // 2, W * tiles * 2, W * tiles * (T + 1),
                       W * tiles * chunks), torch.float64, dev)
    sorted_b, info_b, suffix, losspart = at
    loss = torch.empty(W, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_rank_hinge_sum(a.data_ptr(), b.data_ptr(), sorted_b,
                                    suffix, info_b, losspart,
                                    loss.data_ptr(), n1, n2, W, T, stream)
    _raise_on(err, f"pair_sum[hinge] sort-and-search (W={W}, n1={n1}, "
                   f"n2={n2}, tile {T})")
    return loss


def masked_pair_sums(a, b, ma, mb, hinge: bool) -> torch.Tensor:
    """[W] float64 sums of g(fl(a_i - b_j)) * ma_i * mb_j over each
    problem's pairs for the auc body (hinge False) or the hinge body, NaN
    and infinities as the plain version gives them, for checked contiguous
    float32 CUDA tensors a, ma [W, n1] and b, mb [W, n2] (n1, n2, W > 0;
    finite weights of either sign): b cut into tiles of
    :func:`masked_tile_size` values, sorted once with its weights and
    their float64 suffix sums (the hinge's also of mb * b); each a_i
    searches every tile with the body's float32 predicates and adds its
    weighted part. Three launches (sort, search, a fixed-order sum of the
    partials), so a call repeats bit for bit; with weights in {0, 1} the
    auc is exact."""
    W, n1 = a.shape
    n2 = b.shape[1]
    T = masked_tile_size(n2, hinge)
    tiles = -(-n2 // T)
    if W > _MAX_GRID_YZ or tiles > _MAX_GRID_YZ or max(n1, n2) >= 1 << 31:
        raise ValueError(f"W={W}, n1={n1}, n2={n2} is beyond the CUDA grid "
                         f"of the masked pair sum ({tiles} tiles of {T})")
    lib = load_library()
    chunks = -(-n1 // lib.tw_rank_sum_chunk(T))
    dev = a.device
    # one float64 scratch carved in 8-byte words: the sorted tiles (float32)
    # and the tile infos (int4) first, 16-byte aligned (T / 2 and 2 words
    # a tile), then the suffix sums (one or two words a value) and the
    # partials
    width = 2 if hinge else 1
    wide, at = _carve((W * tiles * T // 2, W * tiles * 2,
                       W * tiles * (T + 1) * width, W * tiles * chunks),
                      torch.float64, dev)
    sorted_b, info_b, suffix, partials = at
    out = torch.empty(W, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tw_rank_masked_sum(
            a.data_ptr(), b.data_ptr(), ma.data_ptr(), mb.data_ptr(),
            sorted_b, suffix, info_b, partials, out.data_ptr(), n1, n2, W, T,
            int(hinge), stream)
    body = "hinge" if hinge else "auc"
    _raise_on(err, f"masked_pair_sum[{body}] sort-and-search (W={W}, "
                   f"n1={n1}, n2={n2}, tile {T})")
    return out
