"""TransformerLM: a decoder-only language model with cached generation
(counterpart of ``analytics_zoo_tpu/capture/lm.py``; ported so far:
``fit``, ``logits``, ``params`` and greedy ``generate``).

The model is an ``nn.Module`` whose parameters carry the JAX package's
tree names: ``embed`` ``[vocab, hidden]`` (tied to the output logits),
``pos`` ``[max_len, hidden]``, ``blocks.<i>.{ln1, qkv, attn_out, ln2,
fc1, fc2}`` (each Dense ``{kernel [in, out], bias}``, each layer norm
``{scale, bias}``) and ``ln_f``, so ``convert.from_jax_params`` maps the
JAX model's params onto ``state_dict`` one for one. They are drawn at
construction from ``seed`` (normal, std 0.02), on the CPU; the first
``fit``, ``logits`` or ``generate`` moves them to its device.

Training runs causal :func:`~analytics_zoo_tpu_torch.ops.attention.
flash_attention` at every length, through ``GraphModel.from_loss`` and
the shared Estimator: on the card every block's forward launches B4 and its
backward B6 or B5a + B5b. Generation prefills the prompt, without its last
token, right-padded to a length bucket, then decodes greedily off the
per-block KV caches (``ops/decode.py``). The prefill's attention takes the
fused short kernel (B7, causal) at a bucketed length of 512 or less and
flash (B4) above, the JAX package's cutover; decoding runs the plain
``masked_context``. The token lookups go through the row-gather kernel
(B1) in clip mode, where the JAX package indexes ``embed`` directly:
the same rows for the ids a vocabulary holds.

Beam search and sampling belong to the ``GenerativeServing`` slice, and
meshes, tensor parallelism and pipeline stages to the model-parallel
slice (6); each raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..common.context import DeviceLike
from ..estimator.estimator import params_tree
from ..keras.layers.attention import _Dense, _LayerNorm
from ..keras.layers.core import get_activation
from ..ops import embedding_kernels as _ek
from ..ops.attention import (flash_attention, fused_short_applicable,
                             fused_short_attention)
from ..ops.decode import cached_attention, greedy_generate, init_kv_cache
from .graph_model import GraphModel

#: prefill length buckets: a prompt is right-padded to the smallest that
#: fits, else to ``max_len`` (the JAX package's)
PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)
_gelu = get_activation("gelu")


def prefill_bucket(length: int, max_len: int) -> int:
    """Smallest prefill bucket >= ``length`` (capped at ``max_len``)."""
    for b in PREFILL_BUCKETS:
        if length <= b <= max_len:
            return b
    return max_len


class _Block(nn.Module):
    """One pre-LN block's parameters."""

    def __init__(self, gen, hidden: int, inter: int):
        super().__init__()
        cpu = torch.device("cpu")
        self.ln1 = _LayerNorm(hidden, cpu)
        self.qkv = _Dense(gen, hidden, 3 * hidden, 0.02, cpu)
        self.attn_out = _Dense(gen, hidden, hidden, 0.02, cpu)
        self.ln2 = _LayerNorm(hidden, cpu)
        self.fc1 = _Dense(gen, hidden, inter, 0.02, cpu)
        self.fc2 = _Dense(gen, inter, hidden, 0.02, cpu)


class TransformerLM(nn.Module):
    """Decoder-only LM: tied-embedding logits, pre-LN blocks, causal
    attention. ``fit(tokens)`` trains next-token prediction;
    ``generate(prompt, max_new_tokens)`` decodes greedily off the KV
    cache."""

    def __init__(self, vocab_size: int, hidden: int = 256, n_block: int = 4,
                 n_head: int = 4, max_len: int = 512,
                 intermediate: Optional[int] = None, optimizer="adam",
                 mesh=None, tensor_parallel: bool = False,
                 pipeline_stages: Optional[int] = None,
                 pipeline_microbatches: Optional[int] = None,
                 seed: int = 0):
        super().__init__()
        if hidden % n_head:
            raise ValueError(f"hidden {hidden} not divisible by "
                             f"heads {n_head}")
        if mesh is not None or tensor_parallel or pipeline_stages:
            raise NotImplementedError(
                "meshes, tensor_parallel and pipeline_stages are not ported "
                "yet (the model-parallel slice, 6)")
        del pipeline_microbatches
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_block = n_block
        self.n_head = n_head
        self.max_len = max_len
        self.intermediate = intermediate or 4 * hidden
        self._head_dim = hidden // n_head
        gen = torch.Generator().manual_seed(seed)
        self.embed = nn.Parameter(torch.randn(vocab_size, hidden,
                                              generator=gen) * 0.02)
        self.pos = nn.Parameter(torch.randn(max_len, hidden,
                                            generator=gen) * 0.02)
        self.blocks = nn.ModuleList(_Block(gen, hidden, self.intermediate)
                                    for _ in range(n_block))
        self.ln_f = _LayerNorm(hidden, torch.device("cpu"))
        self._graph = GraphModel.from_loss(
            lambda m, x, y: m._loss(x), lambda gen, sample_x: self,
            optimizer=optimizer, forward_fn=lambda m, x: m._forward(x))

    # -- training-time forward (full sequence, flash attention) --------------

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.n_head, self._head_dim).transpose(1, 2)

    def _block(self, blk: _Block, x, kv_fn):
        h = blk.ln1(x)
        qkv = h @ blk.qkv.kernel + blk.qkv.bias
        q, k, v = qkv.split(self.hidden, dim=-1)
        ctx = kv_fn(self._split_heads(q), self._split_heads(k),
                    self._split_heads(v))
        b, _, s, _ = ctx.shape
        ctx = ctx.transpose(1, 2).reshape(b, s, self.hidden)
        x = x + ctx @ blk.attn_out.kernel + blk.attn_out.bias
        h = blk.ln2(x)
        h = _gelu(h @ blk.fc1.kernel + blk.fc1.bias)
        return x + h @ blk.fc2.kernel + blk.fc2.bias

    def _embed(self, tokens, start: int = 0):
        s = tokens.shape[1]
        return (_ek.gather_rows_clip(self.embed, tokens.to(torch.int32))
                + self.pos[start:start + s])

    def _forward(self, tokens) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` of a causal forward."""
        x = self._embed(tokens)
        for blk in self.blocks:
            x = self._block(
                blk, x, lambda q, k, v: flash_attention(q, k, v, causal=True))
        return self.ln_f(x) @ self.embed.t()

    def _loss(self, x) -> torch.Tensor:
        """Mean next-token NLL of ``x`` ``[B, S]`` (token ids as floats)."""
        tokens = x.long()
        logits = self._forward(tokens[:, :-1])
        return nn.functional.cross_entropy(
            logits.reshape(-1, self.vocab_size), tokens[:, 1:].reshape(-1))

    # -- generative prefill ---------------------------------------------------

    def _prefill_attn(self, q, k, v):
        """Causal attention for the prefill: the fused short kernel at a
        bucketed length of 512 or less, flash above."""
        if fused_short_applicable(q.shape[-2], k.shape[-2], True):
            return fused_short_attention(q, k, v, causal=True)
        return flash_attention(q, k, v, causal=True)

    def prefill_kv(self, tokens) -> List:
        """Causal forward over a right-padded prompt block ``[B, Tb]``,
        capturing every block's K/V projections ``[B, H, Tb, D]``. Causality
        keeps the real positions independent of the padding."""
        x = self._embed(tokens)
        kvs = []
        for blk in self.blocks:
            holder = {}

            def kv_fn(q, k, v, holder=holder):
                holder["kv"] = (k, v)
                return self._prefill_attn(q, k, v)
            x = self._block(blk, x, kv_fn)
            kvs.append(holder["kv"])
        return kvs

    # -- public surface -------------------------------------------------------

    def _device(self, device: DeviceLike) -> torch.device:
        """The Estimator's device (made on ``device``, the card when
        omitted), with the parameters moved there."""
        dev = self._graph.get_estimator(device).device
        self.to(dev)
        return dev

    def fit(self, tokens, batch_size: int = 32, epochs: int = 1,
            device: DeviceLike = None, **kw):
        """``tokens``: ``[N, S]`` int sequences; trains next-token NLL on
        ``device`` (the card when omitted; later calls reuse it)."""
        return self._graph.fit(np.asarray(tokens, np.float32),
                               batch_size=batch_size, epochs=epochs,
                               device=device, **kw)

    def logits(self, tokens, batch_size: int = 32,
               device: DeviceLike = None) -> np.ndarray:
        """Logits ``[N, S, vocab]`` of a causal forward of ``tokens``."""
        return self._graph.predict(np.asarray(tokens, np.float32),
                                   batch_size=batch_size, device=device)

    @property
    def params(self):
        """The parameters as the JAX package's host tree of numpy arrays."""
        return params_tree(self.named_parameters())

    def generate(self, prompt, max_new_tokens: int,
                 eos_id: Optional[int] = None, beam_size: int = 1,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: Optional[int] = None, device: DeviceLike = None,
                 return_logits: bool = False):
        """Greedy continuation of ``prompt`` ``[B, S]``: prefill the prompt
        minus its last token through the per-block KV caches, then decode
        ``max_new_tokens``. Returns ``[B, max_new_tokens]`` int64 numpy;
        with ``return_logits`` also each step's logits ``[B,
        max_new_tokens, vocab]`` f32."""
        del seed
        if beam_size > 1 or temperature is not None or top_k is not None \
                or top_p is not None:
            raise NotImplementedError(
                "beam search and sampling are not ported yet (the "
                "GenerativeServing slice)")
        dev = self._device(device)
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                 device=dev)
        b, s = prompt.shape
        if s + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len={self.max_len}")
        self.eval()
        with torch.inference_mode():
            caches = [init_kv_cache(b, self.n_head, self.max_len,
                                    self._head_dim, torch.float32, dev)
                      for _ in range(self.n_block)]
            if s > 1:
                tb = prefill_bucket(s - 1, self.max_len)
                padded = torch.zeros((b, tb), dtype=torch.long, device=dev)
                padded[:, :s - 1] = prompt[:, :-1]
                for c, (k, v) in zip(caches, self.prefill_kv(padded)):
                    c["k"][:, :, :tb] = k
                    c["v"][:, :, :tb] = v
                    c["length"] = s - 1

            def step_fn(_, token, caches):
                start = caches[0]["length"]
                x = self._embed(token[:, None], start)
                for blk, cache in zip(self.blocks, caches):
                    x = self._block(blk, x, lambda q, k, v, cache=cache:
                                    cached_attention(q, k, v, cache)[0])
                return self.ln_f(x)[:, -1] @ self.embed.t(), caches

            steps: Optional[List[torch.Tensor]] = [] if return_logits \
                else None
            out = greedy_generate(step_fn, None, caches, prompt[:, -1],
                                  max_new_tokens, eos_id=eos_id,
                                  logits_out=steps)
        tokens = out.cpu().numpy()
        if not return_logits:
            return tokens
        logits = (torch.stack(steps, 1).float().cpu().numpy() if steps else
                  np.zeros((b, 0, self.vocab_size), np.float32))
        return tokens, logits
