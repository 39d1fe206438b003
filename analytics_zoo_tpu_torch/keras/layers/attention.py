"""Attention and transformer layers (counterpart of ``analytics_zoo_tpu/
keras/layers/attention.py``): ``MultiHeadAttention``, ``TransformerLayer``
and ``BERT``.

The parameter tree is the JAX package's, as nested modules: a BERT named
``bert_1`` holds ``word_emb``, ``pos_emb``, ``type_emb``, ``emb_ln``,
``pooler`` and ``block_<i>`` with ``attn.{q,k,v,o}``, ``ln1``, ``ffn_in``,
``ffn_out`` and ``ln2``, so ``state_dict`` keys read
``bert_1.block_0.attn.q.kernel`` and ``convert.from_jax_params`` maps the
JAX package's params by name.

Heads are one ``[b, h, s, d]`` tensor. Attention dispatches as the JAX
package does (its ``attend``), with "on the TPU" read as "on the card":
``q_len == kv_len <= 512`` takes the fused short kernels (B7 forward, B8
backward) with or without dropout, bias or causal mask; on the CPU the same
branch takes their plain versions, so the CPU and the card draw the same
attention-dropout mask. ``kv_len > 512`` takes ``flash_attention`` (B4
forward, B6 or B5a + B5b backward; a padding mask rides into B4 as a key
bias) without attention dropout, and the plain ``blockwise_attention`` with
it. ``use_flash=False`` takes ``dot_product_attention``. The word,
position and type lookups go through the row-gather kernel (B1) in clip
mode, as the JAX package's indexing clamps.

``TransformerLayer`` is the Keras-API causal stack (``bidirectional=False``)
over token and position ids: ``word_emb``, ``pos_emb``, ``pooler`` and
``block_<i>``, BERT's blocks without the type embedding, the embedding
layer norm and the mask. ``compute_dtype`` casts the summed embeddings,
so every dense runs in it; layer norms reduce in f32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..engine import Layer
from .core import dropout, get_activation
from ...ops import attention as _attn
from ...ops import embedding_kernels as _ek

DTypeLike = Union[torch.dtype, str, None]
_gelu = get_activation("gelu")


def _dtype(d: DTypeLike) -> Optional[torch.dtype]:
    """A torch dtype, or its name (``"bfloat16"``, ``"float32"``)."""
    if d is None or isinstance(d, torch.dtype):
        return d
    name = getattr(d, "__name__", str(d)).split(".")[-1]
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype {d!r}: use bfloat16 or float32")
    return getattr(torch, name)


def _normal(gen, shape, scale, device):
    return nn.Parameter((torch.randn(shape, generator=gen) * scale)
                        .to(device))


class _Dense(nn.Module):
    """``{kernel [in, out], bias [out]}``; runs in the input's dtype."""

    def __init__(self, gen, d_in, d_out, init_range, device):
        super().__init__()
        self.kernel = _normal(gen, (d_in, d_out), init_range, device)
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class _LayerNorm(nn.Module):
    """``{scale, bias}``; moments in f32 over the last axis, population
    variance, ``eps`` 1e-5 (the JAX package's, not BERT's 1e-12)."""

    def __init__(self, dim, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, eps: float = 1e-5):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + eps) * self.scale + self.bias
        return y.to(x.dtype)


class MultiHeadAttention(Layer):
    """Batched multi-head self or cross attention. Input: one tensor
    ``[b, s, hidden]``, ``[query, key_value]`` or ``[query, key_value,
    mask]``, the mask ``[b, kv_len]`` 1/0 folded into an additive bias."""

    def __init__(self, n_head: int, hidden_size: Optional[int] = None,
                 attn_drop: float = 0.0, output_drop: float = 0.0,
                 causal: bool = False, init_range: float = 0.02,
                 use_flash: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.n_head = n_head
        self.hidden_size = hidden_size
        self.attn_drop = attn_drop
        self.output_drop = output_drop
        self.causal = causal
        self.init_range = init_range
        self.use_flash = use_flash

    def build(self, generator, input_shape, device):
        shape = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        hidden = self.hidden_size or shape[-1]
        if hidden % self.n_head:
            raise ValueError(f"hidden {hidden} % n_head {self.n_head} != 0")
        self.hidden_size = hidden
        for key, d_in in (("q", shape[-1]), ("k", shape[-1]),
                          ("v", shape[-1]), ("o", hidden)):
            self.add_module(key, _Dense(generator, d_in, hidden,
                                        self.init_range, device))
        self.built = True

    def compute_output_shape(self, input_shape):
        shape = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        return tuple(shape[:-1]) + (self.hidden_size or shape[-1],)

    def _heads(self, x):
        b, s, _ = x.shape
        h = self.n_head
        return x.reshape(b, s, h, self.hidden_size // h).transpose(1, 2)

    def attend(self, x_q, x_kv, mask=None):
        b, sq, _ = x_q.shape
        q = self._heads(self.q(x_q))
        k = self._heads(self.k(x_kv))
        v = self._heads(self.v(x_kv))
        bias = None
        if mask is not None:
            bias = ((1.0 - mask[:, None, None, :].float()) * -1e9
                    ).to(x_q.dtype)
        training = self.training
        gen = self.dropout_generator
        attn_drop = self.attn_drop if training else 0.0
        if attn_drop > 0.0 and gen is None:
            raise ValueError(f"{self.name}: attention dropout in training "
                             f"mode needs the model's dropout generator")
        q_len, kv_len = q.shape[-2], k.shape[-2]
        if self.use_flash and _attn.fused_short_applicable(q_len, kv_len,
                                                           self.causal):
            ctx = _attn.fused_short_attention(
                q, k, v, key_bias=None if bias is None else bias[:, 0, 0, :],
                dropout_rate=attn_drop, generator=gen, causal=self.causal)
        elif self.use_flash and kv_len > _attn.FUSED_SHORT_MAX_SEQ:
            if attn_drop > 0.0:
                # streaming attention with per-block dropout: the [q, kv]
                # probabilities never materialise
                ctx = _attn.blockwise_attention(
                    q, k, v, bias=bias, causal=self.causal,
                    dropout_rate=attn_drop, generator=gen)
            else:
                ctx = _attn.flash_attention(q, k, v, bias=bias,
                                            causal=self.causal)
        else:
            ctx = _attn.dot_product_attention(
                q, k, v, bias=bias, causal=self.causal,
                dropout_rate=attn_drop, generator=gen)
        ctx = ctx.transpose(1, 2).reshape(b, sq, self.hidden_size)
        out = self.o(ctx)
        if training and self.output_drop > 0.0:
            out = dropout(out, self.output_drop, gen)
        return out

    def forward(self, inputs):
        mask = None
        if isinstance(inputs, (list, tuple)):
            x_q, x_kv = inputs[0], inputs[1]
            if len(inputs) > 2:
                mask = inputs[2]
        else:
            x_q = x_kv = inputs
        return self.attend(x_q, x_kv, mask)


class _Block(nn.Module):
    """One encoder block's parameters: ``attn``, ``ln1``, ``ffn_in``,
    ``ffn_out``, ``ln2``."""

    def __init__(self, base: "_TransformerBase", gen, device):
        super().__init__()
        hidden, inter = base.hidden_size, base.intermediate_size
        self.attn = MultiHeadAttention(
            base.n_head, hidden, base.attn_drop, base.hidden_drop,
            causal=base.causal, init_range=base.init_range,
            use_flash=base.use_flash, name=f"{base.name}_attn")
        self.attn.build(gen, (None, None, hidden), device)
        self.ln1 = _LayerNorm(hidden, device)
        self.ffn_in = _Dense(gen, hidden, inter, base.init_range, device)
        self.ffn_out = _Dense(gen, inter, hidden, base.init_range, device)
        self.ln2 = _LayerNorm(hidden, device)


class _TransformerBase(Layer):
    """The encoder stack shared by the transformer layers."""

    def __init__(self, n_block: int, n_head: int, hidden_size: int,
                 intermediate_size: int, hidden_drop: float,
                 attn_drop: float, init_range: float, causal: bool,
                 output_all_block: bool, use_flash: bool = True,
                 compute_dtype: DTypeLike = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.compute_dtype = _dtype(compute_dtype)
        self.n_block = n_block
        self.n_head = n_head
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_drop = hidden_drop
        self.attn_drop = attn_drop
        self.init_range = init_range
        self.causal = causal
        self.output_all_block = output_all_block
        self.use_flash = use_flash

    def _build_blocks(self, gen, device) -> None:
        for i in range(self.n_block):
            self.add_module(f"block_{i}", _Block(self, gen, device))
        self.pooler = _Dense(gen, self.hidden_size, self.hidden_size,
                             self.init_range, device)

    def _dropout(self, x):
        if self.training and self.hidden_drop > 0.0:
            return dropout(x, self.hidden_drop, self.dropout_generator)
        return x

    def _run_block(self, blk: _Block, x, mask):
        a = blk.attn.attend(x, x, mask)
        x = blk.ln1(x + a)
        hmid = _gelu(blk.ffn_in(x))
        h = self._dropout(blk.ffn_out(hmid))
        return blk.ln2(x + h)

    def _stack(self, x, mask):
        all_states = []
        for i in range(self.n_block):
            x = self._run_block(getattr(self, f"block_{i}"), x, mask)
            all_states.append(x)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return (all_states if self.output_all_block else [x]) + [pooled]

    def _stack_output_shape(self, seq):
        states = (None, seq, self.hidden_size)
        pooled = (None, self.hidden_size)
        if self.output_all_block:
            return [states] * self.n_block + [pooled]
        return [states, pooled]


class TransformerLayer(_TransformerBase):
    """GPT-style stack (the JAX package's ``TransformerLayer``): inputs
    ``[token ids [b, s], position ids [b, s]]`` or the token ids alone
    (positions ``arange``); outputs the block state(s) and the pooled
    first-token output."""

    def __init__(self, vocab: int, hidden_size: int = 768, n_block: int = 12,
                 n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 0, hidden_p_drop: float = 0.1,
                 attn_p_drop: float = 0.1, initializer_range: float = 0.02,
                 bidirectional: bool = False, output_all_block: bool = True,
                 use_flash: bool = True, compute_dtype: DTypeLike = None,
                 name: Optional[str] = None):
        super().__init__(n_block, n_head, hidden_size, intermediate_size,
                         hidden_p_drop, attn_p_drop, initializer_range,
                         causal=not bidirectional,
                         output_all_block=output_all_block,
                         use_flash=use_flash, compute_dtype=compute_dtype,
                         name=name)
        self.vocab = vocab
        self.seq_len = seq_len

    def build(self, generator, input_shape, device):
        r = self.init_range
        self.word_emb = _normal(generator, (self.vocab, self.hidden_size), r,
                                device)
        self.pos_emb = _normal(generator, (self.seq_len, self.hidden_size),
                               r, device)
        self._build_blocks(generator, device)
        self.built = True

    def compute_output_shape(self, input_shape):
        shape = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        return self._stack_output_shape(shape[1])

    def forward(self, inputs):
        if isinstance(inputs, (list, tuple)):
            tokens, positions = inputs[0], inputs[1]
        else:
            tokens = inputs
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device).expand(
                tokens.shape)
        x = (_ek.gather_rows_clip(self.word_emb, tokens.to(torch.int32))
             + _ek.gather_rows_clip(self.pos_emb, positions.to(torch.int32)))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return self._stack(x, None)


class BERT(_TransformerBase):
    """BERT encoder: inputs ``[token ids, token type ids, position ids,
    attention mask]``; outputs the block state(s) and the pooled
    first-token output."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12,
                 max_position_len: int = 512, intermediate_size: int = 3072,
                 hidden_p_drop: float = 0.1, attn_p_drop: float = 0.1,
                 initializer_range: float = 0.02,
                 output_all_block: bool = True, use_flash: bool = True,
                 compute_dtype: DTypeLike = None,
                 name: Optional[str] = None):
        super().__init__(n_block, n_head, hidden_size, intermediate_size,
                         hidden_p_drop, attn_p_drop, initializer_range,
                         causal=False, output_all_block=output_all_block,
                         use_flash=use_flash, compute_dtype=compute_dtype,
                         name=name)
        self.vocab = vocab
        self.max_position_len = max_position_len

    def build(self, generator, input_shape, device):
        r = self.init_range
        self.word_emb = _normal(generator, (self.vocab, self.hidden_size), r,
                                device)
        self.pos_emb = _normal(generator,
                               (self.max_position_len, self.hidden_size), r,
                               device)
        self.type_emb = _normal(generator, (2, self.hidden_size), r, device)
        self.emb_ln = _LayerNorm(self.hidden_size, device)
        self._build_blocks(generator, device)
        self.built = True

    def compute_output_shape(self, input_shape):
        shape = input_shape[0] if isinstance(input_shape, list) \
            else input_shape
        return self._stack_output_shape(shape[1])

    def forward(self, inputs):
        if not isinstance(inputs, (list, tuple)) or len(inputs) < 4:
            raise ValueError("BERT expects [token_ids, token_type_ids, "
                             "position_ids, attention_mask]")
        tokens, types, positions, mask = inputs[:4]
        x = (_ek.gather_rows_clip(self.word_emb, tokens)
             + _ek.gather_rows_clip(self.pos_emb, positions)
             + _ek.gather_rows_clip(self.type_emb, types))
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self._dropout(self.emb_ln(x))
        return self._stack(x, mask)
