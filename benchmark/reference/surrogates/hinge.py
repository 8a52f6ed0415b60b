"""l(d) = max(0, 1 - d), l'(d) = -1{d < 1} (0 at the kink)."""

import torch


def terms(d):
    return torch.relu(1.0 - d), -(d < 1.0).to(d.dtype)
