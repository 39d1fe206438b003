"""BERT task estimators (counterpart of ``analytics_zoo_tpu/capture/
text.py``): ``BERTClassifier`` and ``BERTNER`` over the port's BERT layer.

Each wraps BERT and a task head into a compiled ``Sequential`` whose input
is the four-array pack ``[token_ids, token_type_ids, position_ids,
attention_mask]``. ``fit``, ``evaluate`` and ``predict`` run on the card
unless ``device="cpu"`` is passed; later calls reuse the device of the
first. ``bert_serving_forward`` serves a classifier from token rows
through ``InferenceModel.load_forward``. ``BERTSQuAD`` is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..common.context import DeviceLike
from ..keras import Sequential
from ..keras.layers import BERT, Dense, Dropout, Lambda


def bert_input_pack(token_ids: np.ndarray,
                    token_type_ids: Optional[np.ndarray] = None,
                    attention_mask: Optional[np.ndarray] = None):
    """The four-array BERT input: type ids default to 0, positions to
    ``arange``, the mask to nonzero tokens."""
    token_ids = np.asarray(token_ids)
    b, s = token_ids.shape
    if token_type_ids is None:
        token_type_ids = np.zeros((b, s), np.int32)
    if attention_mask is None:
        attention_mask = (token_ids != 0).astype(np.float32)
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return [token_ids.astype(np.int32), np.asarray(token_type_ids, np.int32),
            positions, np.asarray(attention_mask, np.float32)]


def bert_serving_forward(model: torch.nn.Module):
    """``forward(params, x)`` for ``InferenceModel.load_forward``: ``x`` is
    ``[b, s]`` token rows as float32 (the serving wire's tensor records;
    float32 carries an id exactly below 2^24), and the four-array input is
    built on ``x``'s device, as ``bench.py`` builds it inside its trace:
    the ids cast to int, type ids 0, positions ``arange(s)``, the mask
    ``tokens != 0``. ``params`` (``model``'s state-dict keys, e.g. from
    ``convert.from_jax_params``) run ``model`` through
    ``torch.func.functional_call``; ``model`` is put in eval mode."""
    model.eval()

    def forward(params, x):
        tokens = x.to(torch.int32)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).repeat(b, 1)
        packed = [tokens, torch.zeros_like(tokens), positions,
                  (tokens != 0).to(torch.float32)]
        return torch.func.functional_call(model, params, (packed,))

    return forward


def _make_bert(bert_config: Optional[Dict[str, Any]]) -> BERT:
    defaults = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                    max_position_len=512, intermediate_size=3072)
    defaults.update(bert_config or {})
    defaults["output_all_block"] = False
    return BERT(**defaults)


class _BERTEstimator:
    """The shared surface: ``build``, ``fit``, ``predict``."""

    model: Sequential

    def build(self, seq_len: int, generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> "_BERTEstimator":
        """Create the parameters for sequences of ``seq_len`` from
        ``generator`` (seed 0 when omitted) on ``device`` (the card when
        omitted)."""
        self.model.build(generator, [(None, seq_len)] * 4, device=device)
        return self

    def _fit(self, token_ids, labels, batch_size, epochs, device,
             bert_inputs):
        x = bert_input_pack(token_ids, bert_inputs.get("token_type_ids"),
                            bert_inputs.get("attention_mask"))
        return self.model.fit(x, np.asarray(labels, np.float32),
                              batch_size=batch_size, nb_epoch=epochs,
                              device=device)

    def predict(self, token_ids, batch_size: int = 32,
                device: DeviceLike = None, **bert_inputs) -> np.ndarray:
        x = bert_input_pack(token_ids, bert_inputs.get("token_type_ids"),
                            bert_inputs.get("attention_mask"))
        return self.model.predict(x, batch_size=batch_size, device=device)


class BERTClassifier(_BERTEstimator):
    """Sequence classification over the pooled output: BERT, dropout, a
    softmax dense (the JAX package's ``BERTClassifier``)."""

    def __init__(self, num_classes: int, bert_config: Optional[Dict] = None,
                 dropout: float = 0.1, optimizer="adam"):
        bert = _make_bert(bert_config)
        self.model = Sequential([
            bert,
            Lambda(lambda outs: outs[-1], name="take_pooled"),
            Dropout(dropout),
            Dense(num_classes, activation="softmax", name="classifier"),
        ])
        self.model.compile(optimizer, "sparse_categorical_crossentropy",
                           metrics=["accuracy"])

    def fit(self, token_ids, labels, batch_size: int = 32, epochs: int = 1,
            device: DeviceLike = None, **bert_inputs):
        return self._fit(token_ids, labels, batch_size, epochs, device,
                         bert_inputs)

    def evaluate(self, token_ids, labels, batch_size: int = 32,
                 device: DeviceLike = None, **bert_inputs):
        x = bert_input_pack(token_ids, bert_inputs.get("token_type_ids"),
                            bert_inputs.get("attention_mask"))
        return self.model.evaluate(x, np.asarray(labels, np.float32),
                                   batch_size=batch_size, device=device)


class BERTNER(_BERTEstimator):
    """Token tagging over the last block's states, with a per-token sparse
    categorical crossentropy over ``[b, s, C]`` (the JAX package's
    ``BERTNER``)."""

    def __init__(self, num_entities: int, bert_config: Optional[Dict] = None,
                 dropout: float = 0.1, optimizer="adam"):
        bert = _make_bert(bert_config)
        self.model = Sequential([
            bert,
            Lambda(lambda outs: outs[0], name="take_states"),
            Dropout(dropout),
            Dense(num_entities, activation="softmax", name="tagger"),
        ])
        self.model.compile(optimizer, "sparse_categorical_crossentropy")

    def fit(self, token_ids, tag_ids, batch_size: int = 32, epochs: int = 1,
            device: DeviceLike = None, **bert_inputs):
        return self._fit(token_ids, tag_ids, batch_size, epochs, device,
                         bert_inputs)
