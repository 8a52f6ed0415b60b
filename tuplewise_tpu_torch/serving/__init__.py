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

The multi-tenant fleet, recovery and the control plane are not ported
yet.
"""

from tuplewise_tpu_torch.serving.engine import (
    BackpressureError,
    DeadlineExceededError,
    EngineClosedError,
    MicroBatchEngine,
    PoisonEventError,
    ServingConfig,
)
from tuplewise_tpu_torch.serving.index import ExactAucIndex
from tuplewise_tpu_torch.serving.replay import make_stream, replay
from tuplewise_tpu_torch.serving.streaming import StreamingIncompleteU

__all__ = [
    "BackpressureError",
    "DeadlineExceededError",
    "EngineClosedError",
    "ExactAucIndex",
    "MicroBatchEngine",
    "PoisonEventError",
    "ServingConfig",
    "StreamingIncompleteU",
    "make_stream",
    "replay",
]
