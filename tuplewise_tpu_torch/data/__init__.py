"""L0 data (numpy only)."""

from tuplewise_tpu_torch.data.synthetic import make_gaussians, true_gaussian_auc

__all__ = ["make_gaussians", "true_gaussian_auc"]
