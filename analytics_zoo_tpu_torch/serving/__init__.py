"""One-shot cluster serving over the file-spool queue."""
from .client import InputQueue, OutputQueue
from .config import ServingConfig
from .queues import FileQueue, QueueBackend, make_queue
from .server import ClusterServing

__all__ = ["ClusterServing", "FileQueue", "InputQueue", "OutputQueue",
           "QueueBackend", "ServingConfig", "make_queue"]
