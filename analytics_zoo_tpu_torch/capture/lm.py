"""TransformerLM: a decoder-only language model with cached generation
(counterpart of ``analytics_zoo_tpu/capture/lm.py``): ``fit``, ``logits``,
``params``, ``generate`` (greedy, sampled, beam search) and the slot and
paged decode steps that ``GenerativeServing`` runs.

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
token, right-padded to a length bucket, then decodes off the per-block KV
caches (``ops/decode.py``). The prefill's attention takes the fused short
kernel (B7, causal) at a bucketed length of 512 or less and flash (B4)
above, the JAX package's cutover; decoding runs the plain
``masked_context``. The token lookups go through the row-gather kernel
(B1) in clip mode, where the JAX package indexes ``embed`` directly:
the same rows for the ids a vocabulary holds.

``slot_step`` and ``paged_slot_step`` advance every resident stream of a
slot cache or page pool by one token; slot ids, lengths and page tables
are tensors, so their shapes never change as streams join and leave.
``verify_step`` feeds a block of tokens a slot through the page pool in
one pass (B1 once, attention outside any kernel), and
``generate_speculative`` decodes with a draft model proposing and this one
verifying. Sampling draws its Gumbel noise from a ``torch.Generator``
seeded by ``seed`` (``ops/decode.gumbel_noise``, ``spec_draws``), not from
JAX's PRNG.

Meshes, tensor parallelism and pipeline stages belong to the
model-parallel slice (6) and raise ``NotImplementedError``.
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
                             fused_short_attention, masked_context)
from ..ops.decode import (beam_generate, cached_attention, greedy_generate,
                          init_kv_cache, init_paged_pool, init_slot_cache,
                          paged_attention, paged_insert,
                          paged_verify_attention, sample_generate,
                          slot_attention, slot_insert, spec_draws,
                          speculative_generate)
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

    def prefill_kv_suffix(self, tokens, prefix_kvs, prefix_len: int) -> List:
        """Causal forward over a right-padded suffix block ``[B, Tb]`` whose
        positions start at ``prefix_len``, attending over the prefix's K/V
        (``prefix_kvs``: per block ``(k, v)`` ``[B, H, prefix_len, D]``)
        and the suffix itself; returns the suffix's K/V per block. The
        shared-prefix join: the prefix was prefilled once into shared
        pages."""
        s = tokens.shape[1]
        x = self._embed(tokens, prefix_len)
        key_pos = torch.arange(prefix_len + s, device=x.device)
        row_pos = torch.arange(s, device=x.device)
        visible = (key_pos[None, None, None, :]
                   <= prefix_len + row_pos[None, None, :, None])
        kvs = []
        for blk, (pk, pv) in zip(self.blocks, prefix_kvs):
            holder = {}

            def kv_fn(q, k, v, pk=pk, pv=pv, holder=holder):
                holder["kv"] = (k, v)
                k_buf = torch.cat([pk.to(k.dtype), k], dim=2)
                v_buf = torch.cat([pv.to(v.dtype), v], dim=2)
                return masked_context(q, k_buf, v_buf, visible,
                                      1.0 / (q.shape[-1] ** 0.5))
            x = self._block(blk, x, kv_fn)
            kvs.append(holder["kv"])
        return kvs

    # -- slot and paged decode (continuous batching) --------------------------

    def init_slot_caches(self, slots: int, device=None) -> List:
        """One slot cache per block, f32 (the serial ``generate`` caches'
        dtype), on ``device``."""
        return [init_slot_cache(slots, self.n_head, self.max_len,
                                self._head_dim, torch.float32, device)
                for _ in range(self.n_block)]

    def init_paged_caches(self, num_pages: int, page_len: int,
                          int8: bool = False, device=None) -> List:
        """One page pool per block (page 0 the null page), on ``device``."""
        if self.max_len % page_len:
            raise ValueError(f"page_len {page_len} must divide "
                             f"max_len {self.max_len}")
        return [init_paged_pool(num_pages, self.n_head, page_len,
                                self._head_dim, torch.float32, int8=int8,
                                device=device)
                for _ in range(self.n_block)]

    def _decode_step(self, tokens, lengths, attend) -> torch.Tensor:
        """Next-token logits ``[S, vocab]`` of one token a slot: ``tokens``
        ``[S]`` at positions ``lengths`` ``[S]``; ``attend(q, k, v, i)``
        is block i's attention."""
        pos = self.pos[lengths.long().clamp(max=self.max_len - 1)]
        x = (_ek.gather_rows_clip(self.embed, tokens.to(torch.int32)[:, None])
             + pos[:, None])
        for i, blk in enumerate(self.blocks):
            x = self._block(blk, x, lambda q, k, v, i=i: attend(q, k, v, i))
        return self.ln_f(x)[:, -1] @ self.embed.t()

    def slot_step(self, tokens, lengths, caches):
        """One decode step over every slot: feed ``tokens`` ``[S]``, write
        each slot's K/V at its ``lengths[s]`` position and attend against
        its visible prefix. Returns ``(logits [S, vocab], caches)``, the
        caches written in place."""
        logits = self._decode_step(
            tokens, lengths, lambda q, k, v, i: slot_attention(
                q, k, v, caches[i], lengths)[0])
        return logits, caches

    def paged_slot_step(self, tokens, lengths, table, caches):
        """``slot_step`` through the page pools: each slot's K/V lives in
        the pages its ``table`` row names."""
        logits = self._decode_step(
            tokens, lengths, lambda q, k, v, i: paged_attention(
                q, k, v, caches[i], table, lengths, self.max_len)[0])
        return logits, caches

    def verify_step(self, blocks, lengths, table, caches):
        """Speculative verify: feed ``blocks`` ``[S, T]`` (each slot's last
        committed token and T-1 drafts) through the page pools in one pass;
        row j sits at position ``lengths + j``, its K/V written there.
        Returns the full logits ``[S, T, vocab]`` and the caches (written
        in place). Positions past the position table (transient drafts at
        the end of ``max_len``) read its last row, as JAX's clamp does."""
        t = blocks.shape[1]
        positions = (lengths.long()[:, None]
                     + torch.arange(t, device=blocks.device)[None])
        x = (_ek.gather_rows_clip(self.embed, blocks.to(torch.int32))
             + self.pos[positions.clamp(max=self.max_len - 1)])
        for blk, cache in zip(self.blocks, caches):
            x = self._block(blk, x, lambda q, k, v, cache=cache:
                            paged_verify_attention(q, k, v, cache, table,
                                                   lengths)[0])
        return self.ln_f(x) @ self.embed.t(), caches

    def generate_speculative(self, prompt, draft_lm: "TransformerLM",
                             max_new_tokens: int, spec_k: int = 4,
                             eos_id: Optional[int] = None,
                             temperature: Optional[float] = None,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             seed: Optional[int] = None,
                             page_len: int = 16, draws=None,
                             device: DeviceLike = None,
                             stats: Optional[dict] = None) -> np.ndarray:
        """Speculative continuation of ``prompt`` ``[B, S]`` through a paged
        target cache: ``draft_lm`` proposes ``spec_k`` tokens a round off
        its slot cache, this model verifies the block in one
        ``verify_step``, and the accept rule keeps the longest agreeing
        run. Greedy output equals ``generate``'s tokens; sampled
        (``temperature``, ``top_k``, ``top_p``) follows the accept/resample
        rule, its draws from ``spec_draws(seed, ...)`` or from ``draws``
        (the same contract). Both prompts are prefilled through the
        bucketed path ``generate`` takes. ``stats`` receives the rounds and
        the draft tokens proposed and accepted. Returns ``[B,
        max_new_tokens]`` int64 numpy."""
        sampling = (temperature is not None or top_k is not None
                    or top_p is not None)
        prompt = np.asarray(prompt)
        b, s = prompt.shape
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if s + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_len={self.max_len}")
        if s + max_new_tokens + spec_k > draft_lm.max_len:
            raise ValueError(
                f"draft max_len={draft_lm.max_len} too short for prompt "
                f"({s}) + max_new_tokens ({max_new_tokens}) + spec_k "
                f"({spec_k}) transient draft positions")
        if self.max_len % page_len:
            raise ValueError(f"page_len {page_len} must divide "
                             f"max_len {self.max_len}")
        dev = self._device(device)
        draft_lm._device(dev)
        self.eval()
        draft_lm.eval()
        pl = page_len
        # private pages a row, enough for the prompt, the budget and the
        # transient spec_k overshoot; the table is as wide as the server's
        per_row = -(-(s + max_new_tokens + spec_k) // pl)
        width = -(-(self.max_len + spec_k) // pl)
        table_host = np.zeros((b, width), np.int64)
        for r in range(b):
            table_host[r, :per_row] = 1 + r * per_row + np.arange(per_row)
        prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)
        with torch.inference_mode():
            table = torch.as_tensor(table_host, dtype=torch.int32,
                                    device=dev)
            caches = self.init_paged_caches(b * per_row + 1, pl, device=dev)
            dcaches = draft_lm.init_slot_caches(b, device=dev)
            if s > 1:
                tb = prefill_bucket(s - 1, self.max_len)
                padded = torch.zeros((b, tb), dtype=torch.long, device=dev)
                padded[:, :s - 1] = prompt_t[:, :-1]
                for c, (k, v) in zip(caches, self.prefill_kv(padded)):
                    for r in range(b):
                        paged_insert(c, table[r], k[r], v[r])
                dtb = prefill_bucket(s - 1, draft_lm.max_len)
                dpadded = torch.zeros((b, dtb), dtype=torch.long,
                                      device=dev)
                dpadded[:, :s - 1] = prompt_t[:, :-1]
                for c, (k, v) in zip(dcaches, draft_lm.prefill_kv(dpadded)):
                    for r in range(b):
                        slot_insert(c, r, k[r], v[r])
            if sampling and draws is None:
                if seed is None:  # fresh entropy: repeated calls differ
                    seed = int(np.random.SeedSequence().entropy % (2 ** 31))
                draws = spec_draws(seed, b, spec_k, self.vocab_size, dev)
            out = speculative_generate(
                lambda _, toks, ln, dc: draft_lm.slot_step(toks, ln, dc),
                lambda _, block, ln, tc: self.verify_step(block, ln, table,
                                                          tc),
                None, None, dcaches, caches, prompt_t[:, -1],
                torch.full((b,), s - 1, dtype=torch.int32, device=dev),
                max_new_tokens, spec_k, eos_id=eos_id,
                draws=draws if sampling else None,
                temperature=temperature if temperature is not None else 1.0,
                top_k=top_k, top_p=top_p, stats=stats)
        return out.cpu().numpy()

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
        """Continuation of ``prompt`` ``[B, S]``: prefill the prompt minus
        its last token through the per-block KV caches, then decode
        ``max_new_tokens``: greedy by default, beam search (the best beam
        returned) with ``beam_size > 1``, sampled when ``temperature``,
        ``top_k`` or ``top_p`` is given (``seed`` makes the draws
        reproducible; else fresh entropy). Returns ``[B, max_new_tokens]``
        int64 numpy; with ``return_logits`` (greedy or sampled) also each
        step's logits ``[B, max_new_tokens, vocab]`` f32."""
        sampling = (temperature is not None or top_k is not None
                    or top_p is not None)
        if sampling and beam_size > 1:
            raise ValueError("choose either beam_size > 1 or sampling "
                             "(temperature/top_k/top_p), not both")
        if return_logits and beam_size > 1:
            raise ValueError("return_logits is for greedy and sampled "
                             "decoding")
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
            last = prompt[:, -1]
            if beam_size > 1:
                out = beam_generate(step_fn, None, caches, last,
                                    max_new_tokens, beam_size,
                                    eos_id=eos_id)[0][:, 0]
            elif sampling:
                if seed is None:  # fresh entropy: repeated calls differ
                    seed = int(np.random.SeedSequence().entropy % (2 ** 31))
                out = sample_generate(
                    step_fn, None, caches, last, max_new_tokens, seed,
                    temperature if temperature is not None else 1.0, top_k,
                    top_p, eos_id=eos_id, logits_out=steps)
            else:
                out = greedy_generate(step_fn, None, caches, last,
                                      max_new_tokens, eos_id=eos_id,
                                      logits_out=steps)
        tokens = out.cpu().numpy()
        if not return_logits:
            return tokens
        logits = (torch.stack(steps, 1).float().cpu().numpy() if steps else
                  np.zeros((b, 0, self.vocab_size), np.float32))
        return tokens, logits
