"""Serving tier — decode with continuous batching over a paged KV pool
(docs/serving.md).

Counterpart of ``horovod_tpu.serving``, one replica. The train -> save
-> serve path:

  - training commits parameters through the sharded checkpoint engine
    with ``extra=loader.transformer_extra(cfg)``, so the manifest
    records the architecture;
  - :func:`loader.load_params` reads this rank's blocks of them by
    span-overlap reads, whatever mesh they were saved from;
  - :class:`InferenceEngine` schedules requests with per-decode-step
    admission and eviction over the block-sliced KV pool, each forward
    ``Transformer.apply_decode`` on the card;
  - :class:`server.ServingServer` fronts it with stdlib HTTP
    (``/generate``, ``/healthz``, ``/readyz``).

  - :class:`fleet.Fleet` supervises N replica processes and
    :class:`router.Router` fronts them with failover; ``loadgen``
    drives them open-loop.

``python -m horovod_tpu_torch.serving --checkpoint-dir ...`` wires it
up (``--fleet N`` for the supervised fleet).
"""

from .engine import (DEADLINE_ERROR, DrainingError, InferenceEngine,
                     QueueFullError, Request, ServingConfig)
from .kv_cache import (BlockAllocator, PrefixCache, SessionLeaseTable,
                       blocks_needed, prefix_hashes)
from .loader import (TORCH_MODEL_PREFIX, config_from_manifest,
                     load_params, serving_config, transformer_extra)
from .fleet import Fleet, ReplicaEndpoint
from .qos import (AutoscalerConfig, AutoscalerState, ClassQueues,
                  FleetAutoscaler, QosPolicy, QuotaExceededError,
                  QuotaLedger, TenantQos)
from .router import Router, StaticBackends

__all__ = [
    "AutoscalerConfig", "AutoscalerState", "BlockAllocator",
    "ClassQueues", "DEADLINE_ERROR", "DrainingError", "Fleet",
    "FleetAutoscaler", "InferenceEngine", "PrefixCache",
    "QosPolicy", "QueueFullError", "QuotaExceededError", "QuotaLedger",
    "ReplicaEndpoint", "Request", "Router", "ServingConfig",
    "SessionLeaseTable", "StaticBackends", "TORCH_MODEL_PREFIX",
    "TenantQos", "blocks_needed",
    "config_from_manifest", "load_params", "prefix_hashes",
    "serving_config", "transformer_extra",
]
