"""Capture-style training APIs (counterpart of ``analytics_zoo_tpu/
capture/``). Ported so far: the BERT task estimators of ``text.py``,
``GraphModel.from_loss`` and ``TransformerLM``."""
from .graph_model import GraphModel
from .lm import PREFILL_BUCKETS, TransformerLM, prefill_bucket
from .text import BERTClassifier, BERTNER, bert_input_pack

__all__ = ["BERTClassifier", "BERTNER", "GraphModel", "PREFILL_BUCKETS",
           "TransformerLM", "bert_input_pack", "prefill_bucket"]
