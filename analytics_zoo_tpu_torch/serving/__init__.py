"""Cluster serving over the file-spool queue: one-shot models
(``ClusterServing``) and ``TransformerLM`` streams (``GenerativeServing``)."""
from .client import InputQueue, OutputQueue
from .config import ServingConfig
from .queues import FileQueue, QueueBackend, make_queue
from .server import ClusterServing, GenerativeServing, ModelReloadError

__all__ = ["ClusterServing", "FileQueue", "GenerativeServing", "InputQueue",
           "ModelReloadError", "OutputQueue", "QueueBackend",
           "ServingConfig", "make_queue"]
