"""KV-cached decoding (counterpart of ``analytics_zoo_tpu/ops/decode.py``;
ported so far: ``init_kv_cache``, ``cached_attention`` and
``greedy_generate``, whose loop JAX shares with its other selectors).

The cache is a static ``max_len`` buffer pair per block, as in the JAX
package, and visibility is a position mask built from the write position,
so attention always runs over the whole buffer through the shared
:func:`~analytics_zoo_tpu_torch.ops.attention.masked_context`. Two
departures, both for PyTorch's eager execution:

- the buffers are written in place (``cached_attention`` returns the same
  dict, its ``length`` advanced), where JAX's pure functions return new
  arrays; the write position is a host integer, so the overflow guard
  always runs;
- the JAX package's single ``lax.scan`` over the decode steps is a Python
  loop here (a CUDA graph over it is later work).

Slot caches, paged pools, beam search, sampling and speculative decoding
belong to the ``GenerativeServing`` slice and are not ported.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .attention import masked_context

KVCache = Dict[str, Any]


def init_kv_cache(batch: int, heads: int, max_len: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """Empty cache: K/V buffers ``[B, H, max_len, D]`` and the write
    position ``length`` (a host int)."""
    shape = (batch, heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


def cached_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KVCache,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """Write ``k_new``/``v_new`` (``[B, H, T, D]``; T = 1 to decode) at the
    cache's write position, then attend ``q`` against everything cached so
    far, causally within the new block. Returns ``(context [B, H, T, D],
    cache)``; the buffers are updated in place. Raises if the write would
    run past ``max_len``."""
    t, d = q.shape[-2], q.shape[-1]
    max_len = cache["k"].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    start = int(cache["length"])
    if start + t > max_len:
        raise ValueError(f"KV cache overflow: writing {t} tokens at position "
                         f"{start} exceeds max_len={max_len}")
    cache["k"][:, :, start:start + t] = k_new.to(cache["k"].dtype)
    cache["v"][:, :, start:start + t] = v_new.to(cache["v"].dtype)
    # visible: the cached prefix [0, start) and the causal part of the new
    # block [start, start + t)
    key_pos = torch.arange(max_len, device=q.device)[None, :]
    row_pos = start + torch.arange(t, device=q.device)[:, None]
    ctx = masked_context(q, cache["k"], cache["v"], key_pos <= row_pos,
                         scale)
    cache["length"] = start + t
    return ctx, cache


def greedy_generate(step_fn: Callable, params: Any, cache: Any,
                    prompt_last_token: torch.Tensor, max_new_tokens: int,
                    eos_id: Optional[int] = None,
                    logits_out: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Greedy decoding: ``step_fn(params, token [B], cache) -> (logits [B,
    V], cache)`` feeds one token, appending its K/V, and predicts the next.
    Prefill the prompt without its last token and pass that token here.
    With ``eos_id`` finished rows keep emitting it. Appends each step's
    logits to ``logits_out`` when given. Returns ``[B, max_new_tokens]``;
    ``argmax`` takes the first of tied logits, as ``jnp.argmax`` does."""
    token = prompt_last_token
    done = torch.zeros(token.shape, dtype=torch.bool, device=token.device)
    out = []
    for _ in range(max_new_tokens):
        logits, cache = step_fn(params, token, cache)
        if logits_out is not None:
            logits_out.append(logits)
        nxt = torch.argmax(logits, dim=-1).to(token.dtype)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        token = nxt
    if not out:
        return prompt_last_token.new_zeros((token.shape[0], 0))
    return torch.stack(out, 1)  # [B, max_new]
