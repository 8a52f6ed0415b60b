"""tuplewise_tpu_torch — the PyTorch / CUDA port of tuplewise_tpu.

Distributed tuplewise (U-statistic) estimation and learning on one
NVIDIA H100: the same semantics as the JAX package, with its Pallas TPU
kernels rewritten as hand-written CUDA kernels for Hopper (csrc/).
Module names mirror the JAX package so each counterpart is easy to find:

  L0 data        -> tuplewise_tpu_torch.data
  L1 kernels     -> tuplewise_tpu_torch.ops.kernels, ops.pair_kernels,
                    ops.pair_grad_kernels
  L2 partitioner -> tuplewise_tpu_torch.parallel
  L3 estimators  -> tuplewise_tpu_torch.estimators  (Estimator(backend="torch"))
  L4 harness     -> tuplewise_tpu_torch.harness.variance
  L5 learners    -> tuplewise_tpu_torch.models  (train_pairwise, train_curves)

Entry points run on the card unless the caller passes device="cpu".
"""

from tuplewise_tpu_torch.estimators.estimator import Estimator
from tuplewise_tpu_torch.models.pairwise_sgd import (
    TrainConfig, evaluate_auc, split_by_label, train_pairwise,
)
from tuplewise_tpu_torch.models.sim_learner import train_curves
from tuplewise_tpu_torch.ops.kernels import Kernel, get_kernel, register_kernel

__all__ = ["Estimator", "Kernel", "TrainConfig", "evaluate_auc",
           "get_kernel", "register_kernel", "split_by_label",
           "train_curves", "train_pairwise"]
