"""Capture-style training APIs (counterpart of ``analytics_zoo_tpu/
capture/``). Ported so far: the BERT task estimators of ``text.py``."""
from .text import BERTClassifier, BERTNER, bert_input_pack

__all__ = ["BERTClassifier", "BERTNER", "bert_input_pack"]
