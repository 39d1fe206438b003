"""Cluster serving over a spool or Redis queue: one-shot models
(``ClusterServing``) and ``TransformerLM`` streams (``GenerativeServing``),
the retrying client, and the fleet router over many servers."""
from .client import InputQueue, OutputQueue, ResilientClient, RetryBudget
from .config import ServingConfig
from .queues import (CRITICALITY_LANES, FileQueue, QueueBackend, RedisQueue,
                     criticality_of, make_queue)
from .server import ClusterServing, GenerativeServing, ModelReloadError
from .fleet import (FLEET_SHED_ERROR, FleetInstance, FleetRouter,
                    instance_queue, read_health)

__all__ = ["CRITICALITY_LANES", "ClusterServing", "FLEET_SHED_ERROR",
           "FileQueue", "FleetInstance", "FleetRouter", "GenerativeServing",
           "InputQueue", "ModelReloadError", "OutputQueue", "QueueBackend",
           "RedisQueue", "ResilientClient", "RetryBudget", "ServingConfig",
           "criticality_of", "instance_queue", "make_queue", "read_health"]
