"""Moving state between numpy and torch.

``from_numpy`` carries nested dicts, tuples and lists of numpy arrays
(the JAX package's state, once on the host) into tensors on a device;
``to_numpy`` brings tensors back. Floating arrays take ``dtype``;
integer and boolean arrays keep their own type. Other leaves pass
through unchanged.

``params_to_state`` and ``state_to_params`` carry scorer parameters
between the JAX package's form (a dict of numpy arrays, as its
``scorer.init`` and trainers return them) and a port scorer's
``state_dict``; checkpoints and the parity tests use them.
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


def params_to_state(params, device="cpu") -> dict:
    """A JAX-style params dict (numpy arrays, or anything ``np.asarray``
    takes, or tensors) -> float32 tensors under the same names: a port
    scorer's state, for ``load_state_dict``, or the learners' params."""
    return {k: (v.detach() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(device, torch.float32)
            for k, v in params.items()}


def state_to_params(state) -> dict:
    """A port scorer's state (``state_dict()`` or a params dict of
    tensors) -> a JAX-style params dict of numpy arrays."""
    return to_numpy(dict(state))
