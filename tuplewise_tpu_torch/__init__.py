"""tuplewise_tpu_torch — the PyTorch / CUDA port of tuplewise_tpu.

Distributed tuplewise (U-statistic) estimation and learning on one
NVIDIA H100: the same semantics as the JAX package, with its Pallas TPU
kernels rewritten as hand-written CUDA kernels for Hopper (csrc/).
Module names mirror the JAX package so each counterpart is easy to find:

  L0 data        -> tuplewise_tpu_torch.data  (Gaussians, the Adult and
                    MNIST-embedding loaders and their surrogates)
  L1 kernels     -> tuplewise_tpu_torch.ops.kernels, ops.pair_kernels,
                    ops.pair_grad_kernels, ops.triplet_kernels; tuple
                    designs drawn on the card: ops.device_design
  L2 partitioner -> tuplewise_tpu_torch.parallel  (device blocks; the
                    host partitioner and design oracle: parallel.partition)
  L3 estimators  -> tuplewise_tpu_torch.estimators  (Estimator(backend="torch"))
  L4 harness     -> tuplewise_tpu_torch.harness.variance (Monte-Carlo,
                    checkpoint/resume, the three trade-off curves),
                    harness.triplet_experiment (BASELINE config 4)
  L5 learners    -> tuplewise_tpu_torch.models  (train_pairwise,
                    train_curves, train_triplet)
  serving        -> tuplewise_tpu_torch.serving  (ExactAucIndex,
                    MicroBatchEngine, replay; the fleet: TenantFleetIndex,
                    MultiTenantEngine, replay_fleet), estimators.streaming

The flagship forward step is ``tuplewise_tpu_torch.graft_entry.entry``.
Entry points run on the card unless the caller passes device="cpu".
"""

from tuplewise_tpu_torch.estimators.estimator import Estimator
from tuplewise_tpu_torch.estimators.streaming import StreamingEstimator
from tuplewise_tpu_torch.harness.triplet_experiment import (
    triplet_mnist_statistic,
)
from tuplewise_tpu_torch.models.pairwise_sgd import (
    TrainConfig, evaluate_auc, split_by_label, train_pairwise,
)
from tuplewise_tpu_torch.models.sim_learner import train_curves
from tuplewise_tpu_torch.models.triplet_sgd import (
    TripletTrainConfig, evaluate_triplet_accuracy, init_embed, train_triplet,
)
from tuplewise_tpu_torch.ops.kernels import (
    Kernel, auc_kernel, get_kernel, hinge_kernel, logistic_kernel,
    register_kernel, triplet_hinge_kernel, triplet_indicator_kernel,
)
from tuplewise_tpu_torch.serving import (
    ExactAucIndex, MicroBatchEngine, MultiTenantEngine, ServingConfig,
    StreamingIncompleteU, TenancyConfig, TenantFleetIndex, make_stream,
    make_tenant_stream, replay, replay_fleet,
)

__all__ = ["Estimator", "ExactAucIndex", "Kernel", "MicroBatchEngine",
           "MultiTenantEngine", "ServingConfig", "StreamingEstimator",
           "StreamingIncompleteU", "TenancyConfig", "TenantFleetIndex",
           "TrainConfig", "TripletTrainConfig", "auc_kernel",
           "evaluate_auc", "evaluate_triplet_accuracy", "get_kernel",
           "hinge_kernel", "init_embed", "logistic_kernel", "make_stream",
           "make_tenant_stream", "register_kernel", "replay",
           "replay_fleet", "split_by_label", "train_curves",
           "train_pairwise", "train_triplet", "triplet_hinge_kernel",
           "triplet_indicator_kernel", "triplet_mnist_statistic"]
