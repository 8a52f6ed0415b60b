"""Degree-3 (triplet) statistics by distance factorisation: kernel 5 (the
sort-and-count kernels of ``csrc/rank_count.cu``) and its plain PyTorch
version.

The counterpart of ``tuplewise_tpu.ops.pallas_triplets``. The built-in
triplet kernels depend on the three points only through the two anchor
distances,

    h(a, p, n) = g(d(a,p) - d(a,n)),      d = squared euclidean,
    indicator: g(t) = 1{t < -margin}      hinge: g(t) = max(0, margin + t),

so the O(n^3 d) triple loop factorises into O(n^2 d) distance products
(``sqdist_matrix``, a full-precision float32 matmul) and an O(n^3) scalar
reduction per anchor (``batched_masked_pair_sum``, kernel 5):

    S_w = sum_{j,k} g(A[w,j] - B[w,k]) * mp[j] * 1{ip[j] != ia[w]} * mk[k]

for W problems at once: the anchors of a complete statistic, or the
workers x anchors of a local round. Problems come in groups of
``anchors_per_group`` that share their positives and negatives (masks
mp, mk and ids ip are [G, P] / [G, K], one row per group). The kernel
forms the positive weight from the ids itself, so no [P, C] mask matrix
is built. It returns per-problem float64 sums; the callers fold them
with the anchor mask and form the counts exactly in int64 (the JAX
package's float32 counts lose digits at n = 32768).

Dispatch, as in ``ops.pair_kernels``: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises; ``impl="plain"``
is the one explicit route to the plain version on the card. On the card
both combines run the sort-and-count kernels of ``csrc/rank_count.cu``
(``ops.rank_count``: each tile of a problem's negatives sorted with its
weights, every positive searching it by binary search): the indicator
takes the weight of the suffix below -margin, the hinge the two prefix
sums of the weights and of weight times distance where the body is
positive, so its sum is (margin + A) * W - S. A triplet kernel without a
combine (a user-registered one) takes the plain tiled scan
``ops.pair_tiles.triplet_stats`` in ``triplet_stats_best``: that is the
JAX contract, not a fallback. Launches count in
``ops.pair_kernels.LAUNCHES`` under
``"batched_masked_pair_sum[triplet_<kind>]"``.

The TPU budgets of the JAX module (the v5e segment cap ``_SEG``, the
measured tile pickers and the 2 GB anchor chunk) are not copied. The
anchor chunk here comes from ``CHUNK_BYTES``: the float32 distance
blocks of one launch, [G, C, P] and [G, C, K], take at most 4 GiB on the
card (5 % of an H100's 80 GB) and 64 MiB on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

from tuplewise_tpu_torch.ops import pair_tiles, rank_count
from tuplewise_tpu_torch.ops.kernels import (
    Kernel, builtin_triplet_spec, triplet_hinge_combine,
    triplet_indicator_combine,
)
from tuplewise_tpu_torch.ops.pair_kernels import LAUNCHES, plain_tile, use_kernel

CHUNK_BYTES = {"cuda": 4 << 30, "cpu": 64 << 20}


@dataclasses.dataclass(frozen=True)
class TripletCombine:
    """The scalar combine g(t) of a built-in triplet kernel."""

    kind: str          # "indicator" | "hinge"
    margin: float

    @property
    def name(self) -> str:
        return f"triplet_{self.kind}"

    @property
    def cuda_body(self) -> str:
        """The combine's CUDA route (``use_kernel`` reads it): both
        combines have one, a sort-and-count kernel of
        ``csrc/rank_count.cu``."""
        return self.kind

    def g(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "indicator":
            return triplet_indicator_combine(t, self.margin)
        return triplet_hinge_combine(t, self.margin)


def triplet_combine_kernel(kernel: Kernel) -> Optional[TripletCombine]:
    """The distance-difference combine of a built-in triplet kernel, or
    None when the kernel does not factorise (a custom ``triplet_fn``)."""
    spec = builtin_triplet_spec(kernel)
    return None if spec is None else TripletCombine(*spec)


@contextlib.contextmanager
def _ieee_float32_matmul():
    """cuBLAS in IEEE float32 inside the block, whatever the global TF32
    setting, which is restored after."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    if matmul.allow_tf32:
        raise RuntimeError("cannot turn TF32 off for the distance product")
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def sqdist_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., m, k] squared euclidean distances between the rows of a
    [..., m, d] and b [..., k, d]: |a|^2 + |b|^2 - 2 a b^T, with NO clamp
    at 0 (the JAX ``pallas_triplets._sqdist_matrix``; the clamped
    ``ops.kernels._sqdist_matrix`` is another function). The product runs
    in IEEE float32: TF32 would flip indicator decisions on near-ties, as
    bf16 does on the TPU."""
    an = torch.sum(a * a, dim=-1)
    bn = torch.sum(b * b, dim=-1)
    with _ieee_float32_matmul():
        cross = a @ b.transpose(-1, -2)
    return an[..., :, None] + bn[..., None, :] - 2.0 * cross


# --------------------------------------------------------------------- #
# kernel 5 and its plain version                                         #
# --------------------------------------------------------------------- #

def _check(A, B, mp, ip, ia, mk, anchors_per_group):
    """(C, G): problems per group and groups, after checking what the
    kernel takes."""
    if A.dim() != 2 or B.dim() != 2 or B.shape[0] != A.shape[0]:
        raise ValueError(f"expected A [W, P] and B [W, K], got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    W, P = A.shape
    K = B.shape[1]
    C = W if anchors_per_group is None else int(anchors_per_group)
    if C < 1 or W % C:
        raise ValueError(f"W={W} problems do not split into groups of {C}")
    G = W // C
    want = {"mp": (mp, (G, P), torch.float32),
            "ip": (ip, (G, P), torch.int64),
            "ia": (ia, (W,), torch.int64),
            "mk": (mk, (G, K), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (A, B, mp, ip, ia, mk):
        if t.device != A.device:
            raise ValueError(f"tensors on {A.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("the triplet kernel takes contiguous tensors")
    if A.dtype != torch.float32 or B.dtype != torch.float32:
        raise TypeError("the triplet kernel takes float32 distances")
    return C, G


def batched_masked_pair_sum_plain(A, B, mp, ip, ia, mk,
                                  combine: TripletCombine,
                                  anchors_per_group: Optional[int] = None):
    """Plain PyTorch ``batched_masked_pair_sum``: [W] float64 sums of
    g(A[w,j] - B[w,k]) * mp[q,j] * 1{ip[q,j] != ia[w]} * mk[q,k], q the
    group of w, in float32 terms summed in float64."""
    C, _ = _check(A, B, mp, ip, ia, mk, anchors_per_group)
    W, P = A.shape
    K = B.shape[1]
    q = torch.arange(W, device=A.device) // C
    wj = mp[q] * (ip[q] != ia[:, None])                 # [W, P]
    wk = mk[q]                                          # [W, K]
    rows, cols = plain_tile(A, K)
    total = torch.zeros(W, dtype=torch.float64, device=A.device)
    for k0 in range(0, K, cols):
        bk = B[:, None, k0:k0 + cols]
        mkk = wk[:, None, k0:k0 + cols]
        for j0 in range(0, P, rows):
            vals = combine.g(A[:, j0:j0 + rows, None] - bk) * mkk
            total += (vals.sum(2, dtype=torch.float64)
                      * wj[:, j0:j0 + rows]).sum(1)
    return total


def _launch(A, B, mp, ip, ia, mk, combine, anchors_per_group):
    C, _ = _check(A, B, mp, ip, ia, mk, anchors_per_group)
    W, P = A.shape
    K = B.shape[1]
    if W == 0 or P == 0 or K == 0:
        return torch.zeros(W, dtype=torch.float64, device=A.device)
    out = rank_count.triplet_sums(combine.kind, A, B, mp, ip, ia, mk,
                                  combine.margin, C)
    LAUNCHES[f"batched_masked_pair_sum[{combine.name}]"] += 1
    return out


def batched_masked_pair_sum(A, B, mp, ip, ia, mk, combine: TripletCombine,
                            anchors_per_group: Optional[int] = None,
                            impl: Optional[str] = None):
    """[W] float64 per-problem sums (see the module docstring) of A [W, P]
    and B [W, K] float32 distances; mp, ip [G, P], mk [G, K] and ia [W],
    with G = W / anchors_per_group groups (one group by default). The
    weights mp and mk are finite, of either sign: the public masks of
    ``factorized_triplet_stats`` and ``grouped_triplet_stats`` reach them
    unchecked, so the hinge's infinite terms take the sign of their
    weights' product, as in the plain sum (rule 4 of
    ``csrc/rank_count.cu``).

    CUDA tensors launch the sort-and-count kernel of the combine (or
    raise); CPU tensors take ``batched_masked_pair_sum_plain``;
    ``impl="plain"`` forces it."""
    if use_kernel(A, combine, impl):
        return _launch(A, B, mp, ip, ia, mk, combine, anchors_per_group)
    return batched_masked_pair_sum_plain(A, B, mp, ip, ia, mk, combine,
                                         anchors_per_group)


# --------------------------------------------------------------------- #
# the factorised statistics                                              #
# --------------------------------------------------------------------- #

def anchor_chunk(G: int, C: int, P: int, K: int, device) -> int:
    """Anchors per group in one launch: the distance blocks [G, c, P]
    and [G, c, K] of a launch take at most ``CHUNK_BYTES`` of the
    device's kind (at least one anchor)."""
    budget = CHUNK_BYTES["cuda" if torch.device(device).type == "cuda"
                         else "cpu"]
    return max(1, min(C, budget // (4 * G * (P + K) or 1)))


def distance_chunks(Xa, Xp, Y, chunk: int):
    """(a0, D_pa [G, c, P], D_an [G, c, K]) for the anchors a0:a0+c of
    every group, c <= chunk: anchors Xa [G, C, d], positives Xp [G, P, d],
    negatives Y [G, K, d]."""
    for a0 in range(0, Xa.shape[1], chunk):
        xa = Xa[:, a0:a0 + chunk]
        yield a0, sqdist_matrix(xa, Xp), sqdist_matrix(xa, Y)


def triplet_anchor_sums(combine: TripletCombine, Xa, Xp, Y, mp, ip, ia, mk,
                        impl: Optional[str] = None, chunk: int = 0):
    """[G, C] float64 per-anchor sums sum_{j,k} g(d(a,p_j) - d(a,y_k))
    * mp_j * 1{ip_j != ia} * mk_k for anchors Xa [G, C, d] against their
    group's positives Xp [G, P, d] and negatives Y [G, K, d]; mp, ip
    [G, P], ia [G, C], mk [G, K]. The anchor mask is not applied. Anchors
    go in chunks of ``chunk`` per group (0: ``anchor_chunk``), one
    kernel launch each."""
    G, C = Xa.shape[:2]
    P, K = Xp.shape[1], Y.shape[1]
    chunk = chunk or anchor_chunk(G, C, P, K, Xa.device)
    out = torch.empty((G, C), dtype=torch.float64, device=Xa.device)
    mp = mp.to(torch.float32).contiguous()
    mk = mk.to(torch.float32).contiguous()
    ip = ip.to(torch.int64).contiguous()
    ia = ia.to(torch.int64)
    for a0, d_pa, d_an in distance_chunks(Xa, Xp, Y, chunk):
        c = d_pa.shape[1]
        s = batched_masked_pair_sum(
            d_pa.reshape(G * c, P), d_an.reshape(G * c, K), mp, ip,
            ia[:, a0:a0 + c].reshape(-1).contiguous(), mk, combine,
            anchors_per_group=c, impl=impl)
        out[:, a0:a0 + c] = s.reshape(G, c)
    return out


def positive_counts(mp, ip, ia) -> torch.Tensor:
    """[G, C] int64: for each anchor id ia[q, c], the positives of its
    group with mp > 0 and an id other than ia[q, c] (ip, mp [G, P])."""
    order = torch.argsort(ip, dim=-1)
    sid = ip.gather(-1, order).contiguous()
    valid = (mp > 0).gather(-1, order).to(torch.int64)
    cum = torch.nn.functional.pad(valid.cumsum(-1), (1, 0))    # [G, P + 1]
    ia = ia.to(sid.dtype).contiguous()
    lo = torch.searchsorted(sid, ia, right=False)
    hi = torch.searchsorted(sid, ia, right=True)
    return cum[:, -1:] - (cum.gather(-1, hi) - cum.gather(-1, lo))


def _require_combine(kernel: Kernel) -> TripletCombine:
    combine = triplet_combine_kernel(kernel)
    if combine is None:
        raise ValueError(
            f"triplet kernel {kernel.name!r} has no distance factorization; "
            "use pair_tiles.triplet_stats")
    return combine


def _group_stats(kernel, Xa, Xp, Y, ma, mp, ip, ia, my, impl, chunk=0):
    """Per-group (sum [G] float64, count [G] int64): the per-anchor sums
    weighted by the anchor mask ma [G, C], and the cells of nonzero
    weight counted exactly."""
    combine = _require_combine(kernel)
    ip, ia = ip.to(torch.int64), ia.to(torch.int64)
    per = triplet_anchor_sums(combine, Xa, Xp, Y, mp, ip, ia, my, impl, chunk)
    sums = (per * ma.to(torch.float64)).sum(1)
    counts = ((positive_counts(mp, ip, ia) * (ma > 0)).sum(1)
              * (my > 0).sum(1))
    return sums, counts


def grouped_triplet_stats(kernel: Kernel, Xa, Y, ids, mask_a=None,
                          mask_y=None, impl: Optional[str] = None, *,
                          positives=None, mask_p=None, ids_p=None):
    """Per-group (sum [G] float64, count [G] int64) of the triplet
    statistic whose anchors and positives are the rows of Xa [G, m1, d]
    (ids [G, m1], global row ids: rows with equal ids never pair, which
    covers with-replacement duplicates) and negatives the rows of Y
    [G, m2, d]; masks [G, m1] and [G, m2] weight them. A visiting
    positives block (``positives`` [G, mp, d], ``mask_p``, ``ids_p``
    [G, mp]; the mesh's double ring) replaces the anchors as positives.
    A local round's workers, or a ring stop's, are the groups: ONE
    launch for all of them when the distance blocks fit in
    ``CHUNK_BYTES``."""
    ma = (torch.ones(Xa.shape[:2], device=Xa.device) if mask_a is None
          else mask_a)
    my = (torch.ones(Y.shape[:2], device=Xa.device) if mask_y is None
          else mask_y)
    if positives is None:
        positives, mask_p, ids_p = Xa, ma, ids
    elif mask_p is None:
        mask_p = torch.ones(positives.shape[:2], device=Xa.device)
    return _group_stats(kernel, Xa, positives, Y, ma, mask_p, ids_p, ids,
                        my, impl)


def factorized_triplet_stats(
    kernel: Kernel,
    X: torch.Tensor,
    Y: torch.Tensor,
    mask_x: Optional[torch.Tensor] = None,
    mask_y: Optional[torch.Tensor] = None,
    ids_x: Optional[torch.Tensor] = None,
    *,
    positives: Optional[torch.Tensor] = None,
    mask_p: Optional[torch.Tensor] = None,
    ids_p: Optional[torch.Tensor] = None,
    anchor_chunk: int = 0,
    impl: Optional[str] = None,
):
    """(sum, count) of h(x_i, p_j, y_k) over ids_x[i] != ids_p[j], all k:
    the contract of ``pair_tiles.triplet_stats`` (the JAX
    ``pallas_triplet_stats``), at the kernel's rate. Returns a float64
    0-d sum and an int64 0-d count. Raises ValueError for a kernel that
    does not factorise."""
    dev = X.device
    mx = torch.ones(X.shape[0], device=dev) if mask_x is None else mask_x
    my = torch.ones(Y.shape[0], device=dev) if mask_y is None else mask_y
    ix = torch.arange(X.shape[0], device=dev) if ids_x is None else ids_x
    if positives is None:
        positives, mp, ip = X, mx, ix
    else:
        mp = (torch.ones(positives.shape[0], device=dev) if mask_p is None
              else mask_p)
        ip = (torch.arange(positives.shape[0], device=dev) if ids_p is None
              else ids_p)
    sums, counts = _group_stats(kernel, X[None], positives[None], Y[None],
                                mx[None], mp[None], ip[None], ix[None],
                                my[None], impl, anchor_chunk)
    return sums[0], counts[0]


def triplet_stats_best(kernel: Kernel, X, Y, *, impl: Optional[str] = None,
                       tile: int = 128, **kw):
    """The degree-3 dispatch every call site uses: the factorised path
    (kernel 5 on the card) for the two built-in kernels, the plain tiled
    scan ``pair_tiles.triplet_stats`` for a custom triplet kernel. Same
    (sum, count) contract either way; ``kw`` takes the masks, ids and
    visiting positives."""
    if triplet_combine_kernel(kernel) is not None:
        return factorized_triplet_stats(kernel, X, Y, impl=impl, **kw)
    return pair_tiles.triplet_stats(kernel, X, Y, tile=tile, **kw)
