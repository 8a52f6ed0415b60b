"""L1 — tuplewise kernels h, written against torch tensors.

The PyTorch counterpart of ``tuplewise_tpu.ops.kernels``: the same
registry names, the same kernel families and the same bodies, but each
body is a plain function of tensors instead of a function of an array
namespace ``xp``.

* Score-difference kernels (``kind="diff"``): ``h(x, y) = g(s(x) - s(y))``
  — auc, hinge and logistic. ``cuda_body`` is the integer the CUDA pair
  kernels (``csrc/pair_sum.cu``) switch on; a kernel without one (any
  user-registered kernel) runs the plain tiled path on every device.
* Pair feature kernels (``kind="pair"``): within-sample scatter.
* Triplet kernels (``kind="triplet"``): ``h(anchor, positive, negative)``
  on [n, d] features. The two built-in ones depend on the points only
  through d(a,p) - d(a,n), so ``builtin_triplet_spec`` names their
  distance-difference combine and margin; both combines have a CUDA
  route (the sort-and-count kernels of ``csrc/rank_count.cu``). A
  user-registered triplet kernel has no combine and runs the plain
  tiled scan (``ops.pair_tiles.triplet_stats``) on every device.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A tuplewise kernel h, the plugin unit of the framework.

    Attributes:
      name: registry name.
      degree: number of sample points h consumes (2 or 3).
      two_sample: True for two-sample statistics (X vs Y, e.g. AUC).
      kind: "diff", "pair" or "triplet" (see the module docstring).
      diff_fn: ``g(d)`` applied elementwise to a score-difference tensor.
      diff_grad_fn: optional analytic ``g'(d)``.
      pair_fn: ``h(a [m, d], b [k, d]) -> [m, k]`` for pair kernels.
      triplet_fn: ``h(anchor, positive, negative)`` on broadcastable rows.
      pair_elem_fn: elementwise ``h(a_t, b_t)`` on matched rows.
      higher_is_better: metric orientation.
      cuda_body: id of the body compiled into the CUDA pair kernels, or
        None when no CUDA body exists for this kernel.
    """

    name: str
    degree: int
    two_sample: bool
    kind: str
    diff_fn: Optional[Callable[[Tensor], Tensor]] = None
    diff_grad_fn: Optional[Callable[[Tensor], Tensor]] = None
    pair_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None
    triplet_fn: Optional[Callable[..., Tensor]] = None
    pair_elem_fn: Optional[Callable[[Tensor, Tensor], Tensor]] = None
    higher_is_better: bool = True
    cuda_body: Optional[int] = None

    def diff(self, d: Tensor) -> Tensor:
        assert self.kind == "diff", self.name
        return self.diff_fn(d)

    def pair_matrix(self, a: Tensor, b: Tensor) -> Tensor:
        """Kernel matrix between blocks: [m, k]."""
        if self.kind == "diff":
            return self.diff_fn(a[:, None] - b[None, :])
        assert self.kind == "pair", self.name
        return self.pair_fn(a, b)

    def triplet_values(self, a: Tensor, p: Tensor, n: Tensor) -> Tensor:
        assert self.kind == "triplet", self.name
        return self.triplet_fn(a, p, n)

    def pair_elementwise(self, a: Tensor, b: Tensor) -> Tensor:
        """h on matched tuples: a[t] paired with b[t]."""
        if self.kind == "diff":
            return self.diff_fn(a - b)
        assert self.kind == "pair" and self.pair_elem_fn is not None, self.name
        return self.pair_elem_fn(a, b)


# ---------------------------------------------------------------------------
# Score-difference kernels (degree 2). Body ids match csrc/pair_sum.cu (the
# unmasked auc and hinge sums run csrc/rank_count.cu).
# ---------------------------------------------------------------------------

AUC_BODY, HINGE_BODY, LOGISTIC_BODY = 0, 1, 2


def _auc_g(d):
    # 1{d > 0} + 0.5 * 1{d == 0}; -0.0 == 0 counts as a tie
    return (d > 0).to(d.dtype) + 0.5 * (d == 0).to(d.dtype)


def _hinge_g(d):
    # max(0, 1 - d)
    return torch.clamp_min(1.0 - d, 0.0)


def _hinge_gp(d):
    # -1{d < 1}, subgradient 0 at the kink
    return -(d < 1.0).to(d.dtype)


def _logistic_g(d):
    # log(1 + e^{-d}) in the stable form the CUDA body uses:
    # max(-d, 0) + log1p(exp(-|d|))
    return torch.clamp_min(-d, 0.0) + torch.log1p(torch.exp(-d.abs()))


def _logistic_gp(d):
    # -1 / (1 + e^{d})
    return -1.0 / (1.0 + torch.exp(d))


auc_kernel = Kernel(
    name="auc", degree=2, two_sample=True, kind="diff",
    diff_fn=_auc_g, higher_is_better=True, cuda_body=AUC_BODY,
)

hinge_kernel = Kernel(
    name="hinge", degree=2, two_sample=True, kind="diff",
    diff_fn=_hinge_g, diff_grad_fn=_hinge_gp, higher_is_better=False,
    cuda_body=HINGE_BODY,
)

logistic_kernel = Kernel(
    name="logistic", degree=2, two_sample=True, kind="diff",
    diff_fn=_logistic_g, diff_grad_fn=_logistic_gp,
    higher_is_better=False, cuda_body=LOGISTIC_BODY,
)


# ---------------------------------------------------------------------------
# Feature pair kernels (degree 2, one-sample)
# ---------------------------------------------------------------------------

def _sqdist_matrix(a, b):
    """Squared euclidean distances between rows of a [m,d] and b [k,d]."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return torch.clamp_min(d2, 0.0)


def _scatter_h(a, b):
    # within-cluster point scatter h(x, x') = ||x - x'||^2 / 2
    return 0.5 * _sqdist_matrix(a, b)


def _scatter_h_elem(a, b):
    diff = a - b
    return 0.5 * torch.sum(diff * diff, dim=-1)


scatter_kernel = Kernel(
    name="scatter", degree=2, two_sample=False, kind="pair",
    pair_fn=_scatter_h, pair_elem_fn=_scatter_h_elem, higher_is_better=False,
)


# ---------------------------------------------------------------------------
# Triplet kernels (degree 3)
# ---------------------------------------------------------------------------

def _sqdist_vec(a, b):
    diff = a - b
    return torch.sum(diff * diff, dim=-1)


def _triplet_indicator(a, p, n, margin=0.0):
    # 1{ d(anchor, negative) > d(anchor, positive) + margin }
    return (_sqdist_vec(a, n) > _sqdist_vec(a, p) + margin).to(a.dtype)


def _triplet_hinge(a, p, n, margin=1.0):
    # max(0, margin + d(anchor, positive) - d(anchor, negative))
    return torch.clamp_min(margin + _sqdist_vec(a, p) - _sqdist_vec(a, n), 0.0)


triplet_indicator_kernel = Kernel(
    name="triplet_indicator", degree=3, two_sample=True, kind="triplet",
    triplet_fn=_triplet_indicator, higher_is_better=True,
)

triplet_hinge_kernel = Kernel(
    name="triplet_hinge", degree=3, two_sample=True, kind="triplet",
    triplet_fn=_triplet_hinge, higher_is_better=False,
)


# The distance-difference combines g(t), t = d(a,p) - d(a,n), of the two
# built-in triplet kernels. Both run the sort-and-count kernels of
# csrc/rank_count.cu on the card.


def triplet_indicator_combine(t, margin):
    # 1{t < -margin}: d(a,n) > d(a,p) + margin
    return (t < -margin).to(t.dtype)


def triplet_hinge_combine(t, margin):
    # max(0, margin + t)
    return torch.clamp_min(margin + t, 0.0)


def builtin_triplet_spec(kernel: Kernel):
    """("indicator" | "hinge", margin) when ``kernel`` IS one of the two
    built-in triplet kernels (identity of ``triplet_fn``, not the name:
    a custom kernel registered under a built-in name never matches),
    else None. The margin is read off the function's own default."""
    table = {
        triplet_indicator_kernel.triplet_fn: "indicator",
        triplet_hinge_kernel.triplet_fn: "hinge",
    }
    kind = table.get(kernel.triplet_fn)
    if kind is None:
        return None
    margin = inspect.signature(kernel.triplet_fn).parameters["margin"].default
    return kind, float(margin)


_REGISTRY = {
    k.name: k
    for k in [
        auc_kernel,
        hinge_kernel,
        logistic_kernel,
        scatter_kernel,
        triplet_indicator_kernel,
        triplet_hinge_kernel,
    ]
}


def get_kernel(name_or_kernel) -> Kernel:
    """Resolve a kernel by registry name, passing Kernel instances through."""
    if isinstance(name_or_kernel, Kernel):
        return name_or_kernel
    try:
        return _REGISTRY[name_or_kernel]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name_or_kernel!r}; "
            f"available: {sorted(_REGISTRY)}"
        ) from None


def register_kernel(kernel: Kernel) -> Kernel:
    """Register a user-defined kernel (the plugin entry point). A user
    diff kernel has no CUDA body (``cuda_body`` None), so its pair sums
    run the plain tiled path, on the card as on the CPU."""
    _REGISTRY[kernel.name] = kernel
    return kernel
