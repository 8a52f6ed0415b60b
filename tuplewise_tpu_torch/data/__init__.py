"""L0 data (numpy only)."""

from tuplewise_tpu_torch.data.loaders import (
    load_mnist_embeddings, mnist_pca_embeddings,
)
from tuplewise_tpu_torch.data.splits import (
    make_gaussian_splits, standardize_pair, stratified_split,
)
from tuplewise_tpu_torch.data.synthetic import make_gaussians, true_gaussian_auc

__all__ = ["load_mnist_embeddings", "make_gaussian_splits", "make_gaussians",
           "mnist_pca_embeddings", "standardize_pair", "stratified_split",
           "true_gaussian_auc"]
