"""The serving layer on one device: the batch estimators as an online
service.

* ``index.ExactAucIndex``  — incremental exact AUC: sorted base runs on
                             the host with one padded copy on the card,
                             a small merge buffer, O(log n) inserts, one
                             fused count-kernel launch per insert
                             micro-batch (``count_kernel=True``),
                             synchronous or background compaction,
                             sliding-window eviction. Its AUC after any
                             prefix equals the batch rank AUC of that
                             prefix.
* ``streaming.StreamingIncompleteU`` — the incomplete-U budget knob
                             online: B pairs per arrival against
                             reservoir-held history.
* ``engine.MicroBatchEngine`` — the request path: bounded queue, dynamic
                             batcher, flush-on-timeout, backpressure
                             (reject / drop_oldest / block), deadlines,
                             edge validation, stage and host-tax
                             attribution.
* ``replay``               — replay a stream through the engine and
                             report events/s, latency and exact-AUC
                             parity.
* ``tenancy.TenantFleetIndex`` — the multi-tenant fleet: per-tenant
                             exact AUC with every tenant's base runs as
                             rows of two shared device packs, one
                             kernel-7 launch per coalesced batch
                             (``count_kernel=True``), dirty-row
                             placement, whale promotion.
* ``tenancy.MultiTenantEngine`` — the fleet request path: per-tenant
                             queues, admission control, deficit-round-
                             robin scheduling, tenant lifecycle.
* ``replay_fleet``         — replay a tenant-assigned stream
                             (``make_tenant_stream``) through the fleet
                             engine; every tenant's AUC against its
                             oracle.
* ``recovery``             — crash safety: a write-ahead log of admitted
                             batches and asynchronous snapshots
                             (``RecoveryManager``; the fleet's
                             ``tenancy.FleetRecoveryManager``), behind
                             ``ServingConfig.snapshot_dir`` / ``recover``.
* ``control.FleetController`` — the control plane: rides the SLO
                             monitor's signals and actuates the engines'
                             existing knobs (typed per-tenant throttles,
                             the flush window and micro-batch cap, DRR
                             weights, the mesh width, slope-based whale
                             promotion), each actuation flight-evented
                             with its triggering signal.
"""

from tuplewise_tpu_torch.serving.control import (
    ControllerConfig,
    ControllerSpecError,
    FleetController,
)
from tuplewise_tpu_torch.serving.engine import (
    BackpressureError,
    DeadlineExceededError,
    EngineClosedError,
    MicroBatchEngine,
    PoisonEventError,
    ServingConfig,
)
from tuplewise_tpu_torch.serving.index import ExactAucIndex
from tuplewise_tpu_torch.serving.replay import (
    make_stream, make_tenant_stream, replay, replay_fleet,
)
from tuplewise_tpu_torch.serving.streaming import StreamingIncompleteU
from tuplewise_tpu_torch.serving.tenancy import (
    MultiTenantEngine,
    TenancyConfig,
    TenantFleetIndex,
    TenantRejectedError,
    TenantThrottledError,
    tenant_seed,
)

__all__ = [
    "BackpressureError",
    "ControllerConfig",
    "ControllerSpecError",
    "DeadlineExceededError",
    "EngineClosedError",
    "ExactAucIndex",
    "FleetController",
    "MicroBatchEngine",
    "MultiTenantEngine",
    "PoisonEventError",
    "ServingConfig",
    "StreamingIncompleteU",
    "TenancyConfig",
    "TenantFleetIndex",
    "TenantRejectedError",
    "TenantThrottledError",
    "make_stream",
    "make_tenant_stream",
    "replay",
    "replay_fleet",
    "tenant_seed",
]
