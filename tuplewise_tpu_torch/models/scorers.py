"""Scoring models s_theta for pairwise ranking and embedding models
e_theta for the triplet learner, as ``nn.Module``s.

The counterpart of ``tuplewise_tpu.models.scorers`` (the linear scorer
of the paper and a two-layer tanh MLP; the linear and MLP embeddings).
Parameter names and initial
values are the JAX package's: ``init(seed)`` makes the same numpy
``default_rng(seed)`` draws, so both packages start from identical
parameters, and a module's ``state_dict`` holds the same names as the
JAX params dict (``utils.state.params_to_state`` / ``state_to_params``
carry one into the other).

Beside ``forward(X)`` on the module's own parameters, ``score(params,
X)`` scores with a given params dict (``embed(params, X)`` for the
embeddings). Params with a leading replica
axis [S, ...] score batched inputs [S, R, d] into [S, R]: that is how
the learners train S replicas at once without ``vmap``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

Params = Dict[str, np.ndarray]


class _Scorer(nn.Module):
    def __init__(self, seed: int):
        super().__init__()
        for name, value in self.init(seed).items():
            self.register_parameter(
                name, nn.Parameter(torch.as_tensor(value, dtype=torch.float32)))

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.score(dict(self.named_parameters()), X)


class LinearScorer(_Scorer):
    """s(x) = x @ w + b."""

    def __init__(self, dim: int, seed: int = 0):
        self.dim = dim
        super().__init__(seed)

    def init(self, seed: int = 0) -> Params:
        rng = np.random.default_rng(seed)
        return {
            "w": rng.standard_normal(self.dim) / np.sqrt(self.dim),
            "b": np.zeros(()),
        }

    @staticmethod
    def score(params, X: torch.Tensor) -> torch.Tensor:
        w, b = params["w"], params["b"]
        return (X @ w[..., :, None])[..., 0] + b[..., None]


class MLPScorer(_Scorer):
    """Two-layer tanh MLP scorer: s(x) = v @ tanh(x @ W1 + b1) + c."""

    def __init__(self, dim: int, hidden: int = 32, seed: int = 0):
        self.dim, self.hidden = dim, hidden
        super().__init__(seed)

    def init(self, seed: int = 0) -> Params:
        rng = np.random.default_rng(seed)
        return {
            "W1": rng.standard_normal((self.dim, self.hidden)) / np.sqrt(self.dim),
            "b1": np.zeros(self.hidden),
            "v": rng.standard_normal(self.hidden) / np.sqrt(self.hidden),
            "c": np.zeros(()),
        }

    @staticmethod
    def score(params, X: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(X @ params["W1"] + params["b1"][..., None, :])
        return (h @ params["v"][..., :, None])[..., 0] + params["c"][..., None]


def init_scorer(name: str, dim: int, seed: int = 0, **kw):
    """(scorer module, its initial params dict of numpy arrays)."""
    scorer = {"linear": LinearScorer, "mlp": MLPScorer}[name](dim, seed=seed,
                                                             **kw)
    return scorer, scorer.init(seed)


# --------------------------------------------------------------------- #
# Embedding models e_theta: R^d -> R^k for the triplet learner          #
# --------------------------------------------------------------------- #

class _Embed(_Scorer):
    # repr(module) is the JAX dataclass's repr, e.g. "MLPEmbed(dim=8,
    # hidden=16, embed_dim=2)": the triplet learner stores it in its
    # checkpoint config, so a checkpoint of either package resumes in
    # the other
    def extra_repr(self) -> str:
        return ", ".join(f"{k}={getattr(self, k)}" for k in self._fields)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return self.embed(dict(self.named_parameters()), X)


class LinearEmbed(_Embed):
    """e(x) = x @ W, the paper's linear metric (Mahalanobis factor)."""

    _fields = ("dim", "embed_dim")

    def __init__(self, dim: int, embed_dim: int, seed: int = 0):
        self.dim, self.embed_dim = dim, embed_dim
        super().__init__(seed)

    def init(self, seed: int = 0) -> Params:
        rng = np.random.default_rng(seed)
        return {"W": rng.standard_normal((self.dim, self.embed_dim))
                / np.sqrt(self.dim)}

    @staticmethod
    def embed(params, X: torch.Tensor) -> torch.Tensor:
        return X @ params["W"]


class MLPEmbed(_Embed):
    """Two-layer tanh MLP embedding: e(x) = tanh(x @ W1 + b1) @ W2, a
    nonlinear metric through the same budgeted triplet path."""

    _fields = ("dim", "hidden", "embed_dim")

    def __init__(self, dim: int, hidden: int = 32, embed_dim: int = 2,
                 seed: int = 0):
        self.dim, self.hidden, self.embed_dim = dim, hidden, embed_dim
        super().__init__(seed)

    def init(self, seed: int = 0) -> Params:
        rng = np.random.default_rng(seed)
        return {
            "W1": rng.standard_normal((self.dim, self.hidden))
            / np.sqrt(self.dim),
            "b1": np.zeros(self.hidden),
            "W2": rng.standard_normal((self.hidden, self.embed_dim))
            / np.sqrt(self.hidden),
        }

    @staticmethod
    def embed(params, X: torch.Tensor) -> torch.Tensor:
        return torch.tanh(X @ params["W1"] + params["b1"]) @ params["W2"]
