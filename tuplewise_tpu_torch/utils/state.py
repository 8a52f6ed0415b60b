"""Moving state between numpy and torch.

``from_numpy`` carries nested dicts, tuples and lists of numpy arrays
(the JAX package's state, once on the host) into tensors on a device;
``to_numpy`` brings tensors back. Floating arrays take ``dtype``;
integer and boolean arrays keep their own type. Other leaves pass
through unchanged.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(tree, leaf):
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(v, leaf) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return leaf(tree)


def from_numpy(tree, device, dtype=torch.float32):
    """numpy arrays (and numpy scalars) -> tensors on ``device``."""
    def leaf(x):
        if not isinstance(x, (np.ndarray, np.generic)):
            return x
        t = torch.from_numpy(np.array(x, copy=True))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return _map(tree, leaf)


def to_numpy(tree):
    """tensors -> numpy arrays on the host."""
    def leaf(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

    return _map(tree, leaf)
