"""KV-cached decoding (counterpart of ``analytics_zoo_tpu/ops/decode.py``):
the per-request cache (``init_kv_cache``, ``cached_attention``), the slot
caches and the paged pools that ``GenerativeServing`` keeps its resident
streams in, and the greedy, sampled and beam selectors.

Every cache is a static buffer, as in the JAX package, and visibility is a
position mask built from the write positions, so attention always runs
over the whole buffer through the shared
:func:`~analytics_zoo_tpu_torch.ops.attention.masked_context` (plain
PyTorch there too: no TPU kernel is on a decode step). Departures, all for
PyTorch's eager execution:

- the buffers, slot states, page tables and pools are written in place
  (each function returns the same dict or tensor it was given), where
  JAX's pure functions return new arrays; ``cached_attention``'s write
  position is a host integer, so its overflow guard always runs;
- the JAX package's single ``lax.scan`` over the decode steps is a Python
  loop here (a CUDA graph over it is later work);
- the sampled selector is ``argmax(filtered logits + Gumbel noise)``, which
  is what ``jax.random.categorical`` computes, with the noise passed in
  explicitly: :func:`gumbel_noise` draws it from a ``torch.Generator``
  seeded by the request's seed (JAX's PRNG is not reproduced), so a
  stream's draws depend on its seed alone.

Slot ids, lengths, occupancy and page tables are tensors (data), so the
step's shapes never change as streams come and go. Page 0 of a paged pool
is the null page: it absorbs the writes of inactive slots and of positions
past a stream's allocation, and is never visible.

Speculative decoding (Leviathan et al.): a small draft model proposes
``spec_k`` tokens serially and the target verifies them in one batched
pass through its paged pool (:func:`paged_verify_attention`); the accept
rule keeps the longest agreeing run (:func:`spec_accept_greedy`) or, when
sampling, the distribution-preserving accept/resample rule
(:func:`_spec_accept_sampled`). Its draws are explicit tensors
(:func:`spec_draws`, or any source with the same contract), so a test can
feed JAX's. The pool sharding over devices (``shard_paged_pool``) is
ROADMAP Queue A item 7.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .attention import _NEG_INF, masked_context
from .int8_dataflow import next_amax, quant_int8, scale_of_amax

KVCache = Dict[str, Any]
SlotCache = Dict[str, torch.Tensor]
PagedCache = Dict[str, torch.Tensor]


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


# -- slot caches (continuous batching) ----------------------------------------


def init_slot_cache(slots: int, heads: int, max_len: int, head_dim: int,
                    dtype=torch.float32, device=None) -> SlotCache:
    """Per-block K/V buffers ``[S, H, max_len, D]`` for S decode slots; the
    slots' lengths live in the shared slot state (:func:`init_slot_state`)."""
    shape = (slots, heads, max_len, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_slot_state(slots: int, device=None) -> Dict[str, torch.Tensor]:
    """Occupancy shared by every block: each slot's fed-token count
    (int32) and whether it is active."""
    return {"length": torch.zeros(slots, dtype=torch.int32, device=device),
            "active": torch.zeros(slots, dtype=torch.bool, device=device)}


def slot_join(state: Dict[str, torch.Tensor], slot, length
              ) -> Dict[str, torch.Tensor]:
    """Mark ``slot`` occupied with ``length`` tokens already fed (in
    place)."""
    state["length"][slot] = int(length)
    state["active"][slot] = True
    return state


def slot_evict(state: Dict[str, torch.Tensor], mask
               ) -> Dict[str, torch.Tensor]:
    """Vacate every slot where ``mask`` ``[S]`` is True (in place)."""
    mask = torch.as_tensor(mask, device=state["length"].device)
    state["length"].masked_fill_(mask, 0)
    state["active"].masked_fill_(mask, False)
    return state


def slot_insert(cache: SlotCache, slot, k_new: torch.Tensor,
                v_new: torch.Tensor) -> SlotCache:
    """Write a prefilled K/V block ``[H, T, D]`` into ``slot`` at position
    0 (in place)."""
    t = k_new.shape[1]
    cache["k"][slot, :, :t] = k_new.to(cache["k"].dtype)
    cache["v"][slot, :, :t] = v_new.to(cache["v"].dtype)
    return cache


def _visible(lengths: torch.Tensor, t: int, kcols: int) -> torch.Tensor:
    """Each slot's visible prefix ``[S, 1, t, kcols]``: positions up to its
    length, inclusive (the position just written is visible)."""
    key_pos = torch.arange(kcols, device=lengths.device)[None, None, :]
    return (key_pos <= lengths.long()[:, None, None]).expand(
        -1, t, -1)[:, None]


def slot_attention(q: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, cache: SlotCache,
                   lengths: torch.Tensor, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, SlotCache]:
    """One decode step over every slot: write each slot's new K/V
    (``[S, H, 1, D]``) at its own ``lengths[s]`` position, then attend each
    slot's query against its visible prefix with ``cached_attention``'s
    arithmetic. Returns ``(ctx [S, H, 1, D], cache)``; the caller advances
    the lengths once every block has attended. A position past the buffer
    is clamped to its last row, as ``lax.dynamic_update_slice`` does."""
    _, _, t, d = q.shape
    max_len = cache["k"].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rows = torch.arange(q.shape[0], device=q.device)
    pos = lengths.long().clamp(max=max_len - 1)
    cache["k"][rows, :, pos] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][rows, :, pos] = v_new[:, :, 0].to(cache["v"].dtype)
    ctx = masked_context(q, cache["k"], cache["v"],
                         _visible(lengths, t, max_len), scale)
    return ctx, cache


# -- paged pools ----------------------------------------------------------------


def init_paged_pool(num_pages: int, heads: int, page_len: int,
                    head_dim: int, dtype=torch.float32, int8: bool = False,
                    device=None) -> PagedCache:
    """A block's K/V page pool ``[P, H, page_len, D]``; page 0 is the null
    page, so allocators hand out ``1..P-1``. With ``int8`` the pool holds
    int8 codes, a per-position f32 scale ``[P, page_len]`` and the running
    amax scalars of delayed scaling, seeded at 1.0."""
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is the reserved "
                         f"null page), got {num_pages}")
    if page_len < 1:
        raise ValueError(f"page_len must be >= 1, got {page_len}")
    shape = (num_pages, heads, page_len, head_dim)
    if int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "scale_k": torch.zeros(num_pages, page_len, device=device),
                "scale_v": torch.zeros(num_pages, page_len, device=device),
                "amax_k": torch.ones((), device=device),
                "amax_v": torch.ones((), device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def page_table_set(table: torch.Tensor, slot, row) -> torch.Tensor:
    """Install ``row`` ``[W]`` as ``slot``'s page table (in place)."""
    table[slot] = torch.as_tensor(row, dtype=table.dtype, device=table.device)
    return table


def page_table_clear(table: torch.Tensor, mask) -> torch.Tensor:
    """Point every table row where ``mask`` ``[S]`` is True at the null page
    (in place)."""
    mask = torch.as_tensor(mask, device=table.device)
    table.masked_fill_(mask[:, None], 0)
    return table


def page_copy(cache: PagedCache, src, dst) -> PagedCache:
    """Copy page ``src`` into page ``dst`` (in place): the copy-on-write of
    a shared prefix's partly filled tail page."""
    for key in ("k", "v", "scale_k", "scale_v"):
        if key in cache:
            cache[key][dst] = cache[key][src]
    return cache


def _page_positions(table: torch.Tensor, positions: torch.Tensor,
                    page_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical ``positions`` ``[S, T]`` through per-slot ``table`` rows
    ``[S, W]`` to (pool page ids, in-page offsets); a position past a
    row's width lands on the null page."""
    w = table.shape[1]
    idx = positions // page_len
    page = torch.gather(table, 1, idx.clamp(max=w - 1))
    page = torch.where(idx < w, page, torch.zeros_like(page))
    return page.long(), (positions % page_len).long()


def _paged_write(cache: PagedCache, pages: torch.Tensor, offs: torch.Tensor,
                 k_rows: torch.Tensor, v_rows: torch.Tensor,
                 inline_amax: bool) -> PagedCache:
    """Scatter token rows ``[..., H, D]`` (leading dims those of ``pages``)
    into the pool, in place. An int8 pool quantizes on the way in with the
    running amax: ``inline_amax`` (prefills) first folds in the block's own
    amax; the decode step uses the delayed value alone."""
    if "scale_k" not in cache:
        cache["k"][pages, :, offs, :] = k_rows.to(cache["k"].dtype)
        cache["v"][pages, :, offs, :] = v_rows.to(cache["v"].dtype)
        return cache
    kf, vf = k_rows.float(), v_rows.float()
    seen_k, seen_v = kf.abs().max(), vf.abs().max()
    amax_k = (torch.maximum(cache["amax_k"], seen_k) if inline_amax
              else cache["amax_k"])
    amax_v = (torch.maximum(cache["amax_v"], seen_v) if inline_amax
              else cache["amax_v"])
    sk, sv = scale_of_amax(amax_k), scale_of_amax(amax_v)
    cache["k"][pages, :, offs, :] = quant_int8(kf, sk)
    cache["v"][pages, :, offs, :] = quant_int8(vf, sv)
    cache["scale_k"][pages, offs] = sk.expand(pages.shape)
    cache["scale_v"][pages, offs] = sv.expand(pages.shape)
    cache["amax_k"] = next_amax(cache["amax_k"], seen_k)
    cache["amax_v"] = next_amax(cache["amax_v"], seen_v)
    return cache


def paged_gather(cache: PagedCache, table: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's pages in logical order: ``table`` ``[S, C]`` to K/V
    ``[S, H, C·page_len, D]`` (int8 pools dequantized to f32), a transient
    copy beside the pool."""
    idx = table.long()
    k, v = cache["k"][idx], cache["v"][idx]  # [S, C, H, page_len, D]
    if "scale_k" in cache:
        k = k.float() * cache["scale_k"][idx][:, :, None, :, None]
        v = v.float() * cache["scale_v"][idx][:, :, None, :, None]
    s, c, h, pl, d = k.shape
    return (k.permute(0, 2, 1, 3, 4).reshape(s, h, c * pl, d),
            v.permute(0, 2, 1, 3, 4).reshape(s, h, c * pl, d))


def paged_insert(cache: PagedCache, table_row: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, start: int = 0
                 ) -> PagedCache:
    """Write a prefilled K/V block ``[H, T, D]`` into the pages named by
    ``table_row`` ``[W]`` at logical positions ``start..start+T-1`` (in
    place); positions past the row's width fall on the null page."""
    t = k_new.shape[1]
    positions = start + torch.arange(t, device=k_new.device)[None]
    pages, offs = _page_positions(
        torch.as_tensor(table_row, device=k_new.device)[None], positions,
        cache["k"].shape[2])
    return _paged_write(cache, pages, offs, k_new.transpose(0, 1)[None],
                        v_new.transpose(0, 1)[None], inline_amax=True)


def paged_attention(q: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, cache: PagedCache,
                    table: torch.Tensor, lengths: torch.Tensor,
                    max_len: int, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, PagedCache]:
    """:func:`slot_attention` through the page pool: write each slot's new
    K/V at its ``lengths[s]`` position in the page that holds it, gather the
    first ``max_len // page_len`` table columns back into a logical
    ``[S, H, max_len, D]`` view and run the same ``masked_context`` over
    the same mask. Positions past a slot's pages are the null page's, and
    masked to exact zeros."""
    _, _, t, d = q.shape
    page_len = cache["k"].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pages, offs = _page_positions(table, lengths.long()[:, None], page_len)
    _paged_write(cache, pages, offs, k_new.transpose(1, 2),
                 v_new.transpose(1, 2), inline_amax=False)
    k_buf, v_buf = paged_gather(cache, table[:, :max_len // page_len])
    ctx = masked_context(q, k_buf, v_buf, _visible(lengths, t, max_len),
                         scale)
    return ctx, cache


def paged_verify_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, cache: PagedCache,
                           table: torch.Tensor, lengths: torch.Tensor,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, PagedCache]:
    """Speculative verify over every slot: write the T = k+1 new K/V rows
    (``[S, H, T, D]``) at logical positions ``lengths[s] ..
    lengths[s]+T-1``, crossing pages as needed (positions past a stream's
    allocation fall on the null page), then attend each row causally within
    the new block on top of the slot's visible prefix, over all
    ``table.shape[1]`` gathered columns (the slack past ``max_len`` masked
    to exact zeros). Returns ``(ctx [S, H, T, D], cache)``. The caller
    advances lengths by the accepted count, not by T: rejected positions
    keep stale K/V that the next round overwrites at the same positions.
    The T-batched products round differently from T serial steps, so
    speculative parity is token identity, not bit identity."""
    s, _, t, d = q.shape
    page_len = cache["k"].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    positions = (lengths.long()[:, None]
                 + torch.arange(t, device=q.device)[None])
    pages, offs = _page_positions(table, positions, page_len)
    _paged_write(cache, pages, offs, k_new.transpose(1, 2),
                 v_new.transpose(1, 2), inline_amax=False)
    k_buf, v_buf = paged_gather(cache, table)
    kcols = table.shape[1] * page_len
    key_pos = torch.arange(kcols, device=q.device)[None, None, :]
    row_pos = torch.arange(t, device=q.device)[None, :, None]
    visible = key_pos <= lengths.long()[:, None, None] + row_pos
    ctx = masked_context(q, k_buf, v_buf, visible[:, None], scale)
    return ctx, cache


# -- selectors --------------------------------------------------------------


def _decode_loop(step_fn, params, cache, prompt_last_token, max_new_tokens,
                 eos_id, select_fn, logits_out=None) -> torch.Tensor:
    """Feed a token, select the next by ``select_fn(logits, step)``, force
    ``eos_id`` on finished rows; ``[B, max_new_tokens]``."""
    token = prompt_last_token
    done = torch.zeros(token.shape, dtype=torch.bool, device=token.device)
    out = []
    for i in range(max_new_tokens):
        logits, cache = step_fn(params, token, cache)
        if logits_out is not None:
            logits_out.append(logits)
        nxt = select_fn(logits, i).to(token.dtype)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        token = nxt
    if not out:
        return prompt_last_token.new_zeros((token.shape[0], 0))
    return torch.stack(out, 1)


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
    return _decode_loop(step_fn, params, cache, prompt_last_token,
                        max_new_tokens, eos_id,
                        lambda logits, _: torch.argmax(logits, dim=-1),
                        logits_out)


def beam_generate(step_fn: Callable, params: Any, cache: Any,
                  prompt_last_token: torch.Tensor, max_new_tokens: int,
                  beam_size: int, eos_id: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search with :func:`greedy_generate`'s ``step_fn`` contract over
    ``N = batch · beam_size`` rows. Every cache tensor whose leading axis is
    the batch is repeated ``beam_size``-fold and reordered by backpointer
    each step; a finished beam (it emitted ``eos_id``) keeps its score and
    pads with eos. Returns ``(sequences [B, beam, max_new], scores [B,
    beam])``, best first by summed log-probability."""
    b, k = prompt_last_token.shape[0], beam_size
    dev = prompt_last_token.device

    def remap(tree, fn, lead):
        if isinstance(tree, dict):
            return {key: remap(val, fn, lead) for key, val in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(remap(val, fn, lead) for val in tree)
        if (isinstance(tree, torch.Tensor) and tree.dim() > 0
                and tree.shape[0] == lead):
            return fn(tree)
        return tree

    caches = remap(cache, lambda a: a.repeat_interleave(k, 0), b)
    tokens = prompt_last_token[:, None].repeat(1, k)  # [B, K]
    # beam 0 alone is live at first, so the first expansion picks k
    # distinct continuations rather than k copies of the argmax
    scores = torch.tensor([0.0] + [_NEG_INF] * (k - 1),
                          device=dev).repeat(b, 1)
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    seqbuf = torch.zeros((b, k, max_new_tokens),
                         dtype=prompt_last_token.dtype, device=dev)
    for i in range(max_new_tokens):
        logits, caches = step_fn(params, tokens.reshape(b * k), caches)
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        if eos_id is not None:
            # a finished beam may only continue with eos, at no cost
            eos_row = torch.full((v,), _NEG_INF, device=dev)
            eos_row[eos_id] = 0.0
            logp = torch.where(done[..., None], eos_row, logp)
        cand = (scores[..., None] + logp).reshape(b, k * v)
        scores, idx = torch.topk(cand, k, dim=-1)
        parent = idx // v
        token = (idx % v).to(tokens.dtype)
        flat = (parent + torch.arange(b, device=dev)[:, None] * k).reshape(-1)
        caches = remap(caches, lambda a: a.index_select(0, flat), b * k)
        seqbuf = torch.gather(seqbuf, 1, parent[..., None].expand(
            -1, -1, max_new_tokens)).clone()
        seqbuf[:, :, i] = token
        done = torch.gather(done, 1, parent)
        if eos_id is not None:
            done = done | (token == eos_id)
        tokens = token
    return seqbuf, scores


def make_logit_filter(temperature: float = 1.0, top_k: Optional[int] = None,
                      top_p: Optional[float] = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The sampling filter that :func:`sample_generate` and
    ``GenerativeServing`` share: temperature scales the logits, ``top_k``
    keeps the k highest, ``top_p`` keeps the smallest prefix of the sorted
    distribution whose probability reaches ``top_p`` (at least one token);
    the rest score ``-1e30``."""
    if temperature <= 0:
        raise ValueError("temperature must be > 0 (use greedy_generate "
                         "for deterministic argmax decoding)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k} "
                         "(pass top_k=None to disable)")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p} "
                         "(pass top_p=None to disable)")

    def filter_logits(logits: torch.Tensor) -> torch.Tensor:
        logits = logits / temperature
        if top_k is not None:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, _NEG_INF, logits)
        if top_p is not None:
            sorted_logits = torch.sort(logits, dim=-1, descending=True).values
            probs = torch.softmax(sorted_logits, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            cutoff_idx = ((cum - probs) < top_p).sum(-1, keepdim=True) - 1
            cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
            logits = torch.where(logits < cutoff, _NEG_INF, logits)
        return logits

    return filter_logits


def gumbel_noise(seed: int, shape, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` of ``shape``, f32, ``u``
    uniform from a ``torch.Generator`` seeded with ``seed`` on the CPU
    (floored at f32's smallest normal, as JAX's uniform is), then moved to
    ``device``: the same draws on every device. Draws are consecutive, so
    ``[n, ...]`` begins with the ``[m, ...]`` draws of any m < n."""
    gen = torch.Generator().manual_seed(int(seed))
    u = torch.rand(tuple(shape), generator=gen).clamp_min(
        torch.finfo(torch.float32).tiny)
    return (-torch.log(-torch.log(u))).to(device)


def sampled_select(filtered: torch.Tensor, noise: torch.Tensor
                   ) -> torch.Tensor:
    """The categorical draw of ``jax.random.categorical``: ``argmax(noise +
    filtered logits)`` over the last axis."""
    return torch.argmax(noise + filtered, dim=-1)


def sample_generate(step_fn: Callable, params: Any, cache: Any,
                    prompt_last_token: torch.Tensor, max_new_tokens: int,
                    seed: int, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    eos_id: Optional[int] = None,
                    logits_out: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Sampled decoding (temperature / top-k / nucleus, the filter of
    :func:`make_logit_filter`) with :func:`greedy_generate`'s contract.
    Step i draws with row i of ``gumbel_noise(seed, [max_new_tokens, B,
    vocab])``. Finished rows keep emitting ``eos_id``."""
    filter_logits = make_logit_filter(temperature, top_k, top_p)
    noise: List[torch.Tensor] = []

    def select(logits, i):
        if not noise:
            noise.append(gumbel_noise(
                seed, (max_new_tokens,) + tuple(logits.shape),
                logits.device))
        return sampled_select(filter_logits(logits.float()), noise[0][i])

    return _decode_loop(step_fn, params, cache, prompt_last_token,
                        max_new_tokens, eos_id, select, logits_out)


# -- speculative decoding ---------------------------------------------------------
#
# The decode step is bound by memory bandwidth, so a small DRAFT model
# proposes k tokens serially and the TARGET verifies all k in one batched
# pass: one target pass emits between 1 and k+1 tokens. Greedy, the accept
# rule is "accept while the draft matches the target's argmax", which makes
# speculative greedy token-identical to serial greedy. Rejected drafts leave
# stale K/V past the accepted length, invisible under the length mask and
# overwritten at the same positions in the next round: no rollback.


def spec_accept_greedy(drafts: torch.Tensor, target_logits: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy accept rule. ``drafts`` ``[S, k]`` are the proposals and
    ``target_logits`` ``[S, k+1, V]`` the verify pass's (row j predicts the
    token after draft j). Returns ``(emitted [S, k+1], n [S])``: the
    target's argmax a position and how many lead entries are valid, ``n =
    1 + (leading draft/argmax matches)``, so a round whose drafts all agree
    emits k+1 tokens."""
    g = torch.argmax(target_logits, dim=-1)
    match = (drafts == g[:, :-1]).to(torch.int32)
    n = 1 + torch.cumprod(match, dim=1).sum(dim=1)
    return g, n


def _spec_accept_sampled(drafts: torch.Tensor, draft_logits: torch.Tensor,
                         target_logits: torch.Tensor, uniform: torch.Tensor,
                         gumbel: torch.Tensor,
                         filter_logits: Callable[[torch.Tensor],
                                                 torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stochastic accept/resample rule: accept draft token d_i with
    probability min(1, p_i(d_i) / q_i(d_i)) (``uniform`` ``[S, k]``); at
    the first rejection draw from norm(max(p - q, 0)), and when every draft
    survives draw the bonus token from the target's last distribution (q is
    0 there, so the residual is p). Where the residual sums to zero (p ==
    q) the draw is from p. The draw is ``argmax(log residual + gumbel)``
    (``gumbel`` ``[S, V]``), ``jax.random.categorical``'s. Returns
    ``(emitted [S, k+1], n [S])`` as :func:`spec_accept_greedy`; the output
    follows the target's distribution."""
    s, k = drafts.shape
    p = torch.softmax(filter_logits(target_logits.float()), dim=-1)
    q = torch.softmax(filter_logits(draft_logits.float()), dim=-1)
    idx = drafts.long()[..., None]
    pd = torch.gather(p[:, :k], -1, idx)[..., 0]
    qd = torch.gather(q, -1, idx)[..., 0]
    accept = (uniform * qd < pd).to(torch.int32)
    m = torch.cumprod(accept, dim=1).sum(dim=1)        # [S] in [0, k]
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    rows = torch.arange(s, device=drafts.device)
    pm, qm = p[rows, m], q_pad[rows, m]                 # [S, V]
    resid = torch.clamp_min(pm - qm, 0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 0, resid, pm)
    logits = torch.where(resid > 0, torch.log(resid),
                         torch.full_like(resid, _NEG_INF))
    x = torch.argmax(logits + gumbel, dim=-1).to(drafts.dtype)
    j = torch.arange(k + 1, device=drafts.device)[None]
    drafts_pad = torch.cat([drafts, drafts.new_zeros((s, 1))], dim=1)
    emitted = torch.where(j < m[:, None], drafts_pad,
                          torch.where(j == m[:, None], x[:, None],
                                      torch.zeros_like(drafts_pad)))
    return emitted, m + 1


def spec_draws(seed: int, batch: int, spec_k: int, vocab: int, device=None
               ) -> Callable[[int], Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]]:
    """The draws of sampled speculative rounds, from one CPU
    ``torch.Generator`` seeded with ``seed``: round r takes, in order, the
    drafts' Gumbel noise ``[k, B, V]``, the accept uniforms ``[B, k]``
    (floored at f32's smallest normal) and the residual draw's Gumbel noise
    ``[B, V]``. Rounds must be asked for in order; the draws depend on the
    seed alone, on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    tiny = torch.finfo(torch.float32).tiny
    state = {"next": 0}

    def gumbel(shape):
        u = torch.rand(shape, generator=gen).clamp_min(tiny)
        return -torch.log(-torch.log(u))

    def draw(r: int):
        if r != state["next"]:
            raise ValueError(f"spec_draws: round {r} asked for after "
                             f"{state['next'] - 1}; rounds go in order")
        state["next"] += 1
        g_draft = gumbel((spec_k, batch, vocab))
        u = torch.rand((batch, spec_k), generator=gen).clamp_min(tiny)
        g_resid = gumbel((batch, vocab))
        return (g_draft.to(device), u.to(device), g_resid.to(device))

    return draw


def speculative_generate(draft_step_fn: Callable, verify_fn: Callable,
                         draft_params: Any, target_params: Any,
                         draft_cache: Any, target_cache: Any,
                         prompt_last_token: torch.Tensor,
                         lengths: torch.Tensor, max_new_tokens: int,
                         spec_k: int, eos_id: Optional[int] = None,
                         draws: Optional[Callable] = None,
                         temperature: float = 1.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         stats: Optional[Dict[str, int]] = None
                         ) -> torch.Tensor:
    """Speculative decoding: at most ``max_new_tokens`` rounds, each
    ``spec_k`` serial draft steps, one batched target verify and the accept
    rule. Lengths are a row's own (slot and paged style):

    - ``draft_step_fn(draft_params, tokens [B], lengths [B], draft_cache)
      -> (logits [B, V], draft_cache)``
    - ``verify_fn(target_params, block [B, k+1], lengths [B],
      target_cache) -> (logits [B, k+1, V], target_cache)``

    Greedy when ``draws`` is None (token-identical to serial greedy);
    otherwise it samples through :func:`make_logit_filter`'s chain, round r
    taking ``draws(r) -> (draft gumbel [k, B, V], uniform [B, k], residual
    gumbel [B, V])`` (:func:`spec_draws`). Finished rows (eos or budget)
    freeze and the output pads with ``eos_id``; the loop ends once every
    row is done. ``stats``, when given, receives ``rounds``, ``proposed``
    (draft tokens offered to rows still live) and ``accepted`` (of those,
    the ones the rule kept). Returns ``[B, max_new_tokens]``."""
    b, dev = prompt_last_token.shape[0], prompt_last_token.device
    sampling = draws is not None
    filt = (make_logit_filter(temperature, top_k, top_p) if sampling
            else None)
    last = prompt_last_token
    ln = torch.as_tensor(lengths, device=dev).to(torch.int32)
    fill = eos_id if eos_id is not None else 0
    out = torch.full((b, max_new_tokens + 1), fill, dtype=last.dtype,
                     device=dev)  # the last column takes dropped writes
    cursor = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    j = torch.arange(spec_k + 1, device=dev)[None]
    rows = torch.arange(b, device=dev)[:, None].expand(-1, spec_k + 1)
    rounds = proposed = accepted = 0
    for r in range(max_new_tokens):
        if sampling:
            g_draft, uniform, g_resid = draws(r)
        tok, dl = last, ln
        drafts, dlogits = [], []
        for i in range(spec_k):
            logits, draft_cache = draft_step_fn(draft_params, tok, dl,
                                                draft_cache)
            if sampling:
                nxt = sampled_select(filt(logits.float()), g_draft[i])
                dlogits.append(logits)
            else:
                nxt = torch.argmax(logits, dim=-1)
            tok = nxt.to(last.dtype)
            drafts.append(tok)
            dl = dl + 1
        drafts_t = torch.stack(drafts, dim=1)                # [B, k]
        block = torch.cat([last[:, None], drafts_t], dim=1)
        tlogits, target_cache = verify_fn(target_params, block, ln,
                                          target_cache)
        if sampling:
            emitted, n = _spec_accept_sampled(
                drafts_t, torch.stack(dlogits, dim=1), tlogits, uniform,
                g_resid, filt)
        else:
            emitted, n = spec_accept_greedy(drafts_t, tlogits)
        emitted = emitted.to(last.dtype)
        n = torch.where(done, 0, n.to(torch.int32))
        if stats is not None:
            live = int((~done).sum())
            proposed += spec_k * live
            accepted += int((n - 1).clamp_min(0).sum())
        n = torch.minimum(n, max_new_tokens - cursor)        # budget clamp
        if eos_id is not None:
            iseos = (emitted == eos_id) & (j < n[:, None])
            first = torch.where(iseos, j, spec_k + 1).min(dim=1).values
            n = torch.minimum(n, (first + 1).to(n.dtype))
            done = done | iseos.any(dim=1)
        pos = torch.where(j < n[:, None], cursor[:, None] + j,
                          max_new_tokens)
        out[rows, pos.long()] = emitted
        prev = torch.gather(emitted, 1, (n - 1).clamp_min(0).long()[:, None])
        last = torch.where(n > 0, prev[:, 0], last)
        ln = ln + n
        cursor = cursor + n
        done = done | (cursor >= max_new_tokens)
        rounds += 1
        if bool(done.all()):
            break
    if stats is not None:
        stats.update(rounds=rounds, proposed=proposed, accepted=accepted)
    return out[:, :max_new_tokens]
