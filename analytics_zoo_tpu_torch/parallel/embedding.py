"""Vocab-sharded embedding engine and id validation (counterpart of
``analytics_zoo_tpu/parallel/embedding.py``; the host-memory cold tier is
not ported).

A vocab-sharded table is split over the ranks of a :class:`~.mesh.Mesh`:
rank ``r`` holds rows ``[r * rows_per_shard, (r + 1) * rows_per_shard)`` of
the table padded with zero rows to ``shards * rows_per_shard``
(:class:`ShardSpec`). Every step stays sparse, as in the JAX package:

* forward (:func:`sharded_lookup`): each rank dedups its ids with a
  static-size unique (:func:`_routing`), sends each unique to its owning
  rank with one all-to-all, gathers the rows it was asked for through the
  row-gather kernel (fill mode: the SENTINEL row reads zeros) and sends
  them back with a second all-to-all;
* backward: the cotangent is summed per unique (``segment_grads``), sent
  back to the owners with a third all-to-all, and scatter-added into this
  rank's ``[rows_per_shard, dim]`` block by the scatter kernel
  (``ops.embedding_kernels.scatter_rows``, B3 on the card);
* update (:func:`apply_row_update`): sgd, adagrad or lazy adam on only the
  rows other ranks asked for, in place.

The exchanges run on ``mesh``'s process group, in the JAX package's block
order (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``). Every
rank must run every sharded lookup's forward and backward, in the same
order: each is a collective.

JAX's ``fused_kernels`` has no counterpart: the port has one gather path,
so ``kernels.fused_embedding`` selects nothing.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..common.config import global_config
from ..ops import embedding_kernels as _ek
from .mesh import Mesh, default_mesh, embedding_axis

_oob_lock = threading.Lock()
#: device -> int64 scalar counting out-of-range ids seen in ``count`` mode
_oob_counters: Dict[torch.device, torch.Tensor] = {}


def _oob_counter(device: torch.device) -> torch.Tensor:
    c = _oob_counters.get(device)
    if c is None:
        # made outside inference mode, so training steps can add to it too
        with torch.inference_mode(False), torch.no_grad():
            c = torch.zeros((), dtype=torch.int64, device=device)
        _oob_counters[device] = c
    return c


def oob_ids_total() -> int:
    """Out-of-range ids counted so far, summed over devices. Reads the
    device counters, so it waits for the device: call it off the hot path."""
    with _oob_lock:
        counters = list(_oob_counters.values())
    return int(sum(int(c.item()) for c in counters))


def reset_oob_ids() -> None:
    with _oob_lock:
        _oob_counters.clear()


def validate_ids(idx: torch.Tensor, vocab: int,
                 allow_negative: bool = False) -> torch.Tensor:
    """Apply the ``data.validate_ids`` policy to an integer id tensor.

    * ``clamp``: clip to ``[0, vocab-1]`` silently.
    * ``count`` (default): clip, and add the offenders to a counter on the
      ids' device. Nothing waits for the device; :func:`oob_ids_total`
      reads the counter when asked.
    * ``raise``: raise ValueError on any offender. This reads the count on
      the host, so it waits for the device on every lookup.

    ``allow_negative`` keeps negative ids intact (``SparseEmbedding`` masks
    them as padding downstream); only the upper bound is then validated.
    """
    mode = str(global_config().get("data.validate_ids"))
    if mode not in ("clamp", "count", "raise"):
        raise ValueError(f"data.validate_ids={mode!r}: expected "
                         f"'clamp', 'count' or 'raise'")
    if allow_negative:
        clamped = idx.clamp(max=vocab - 1)
        if mode == "clamp":
            return clamped
        bad = idx >= vocab
    else:
        clamped = idx.clamp(0, vocab - 1)
        if mode == "clamp":
            return clamped
        bad = (idx < 0) | (idx >= vocab)
    n_bad = bad.sum()
    if mode == "raise":
        count = int(n_bad)
        if count:
            raise ValueError(
                f"{count} embedding id(s) out of range [0, {vocab}) "
                f"(data.validate_ids=raise)")
        return clamped
    with _oob_lock:
        _oob_counter(idx.device).add_(n_bad)
    return clamped



# -- shard description ----------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSpec:
    """One vocab-sharded table: ``shards`` ranks of ``mesh`` along ``axis``,
    each holding ``rows_per_shard`` rows of ``dim``; ``vocab`` is the
    unpadded row count."""
    mesh: Mesh
    axis: str
    shards: int
    rows_per_shard: int
    vocab: int
    dim: int

    @property
    def padded(self) -> int:
        """The padded vocab, and the SENTINEL id: it routes to the last rank
        with a local row out of range, so its gather reads zeros and its
        gradient drops."""
        return self.shards * self.rows_per_shard

    @property
    def table_bytes(self) -> int:
        return self.padded * self.dim * 4

    @property
    def device_bytes(self) -> int:
        return self.rows_per_shard * self.dim * 4


def make_shard_spec(vocab: int, dim: int, mesh: Optional[Mesh] = None,
                    axis: Optional[str] = None) -> Optional[ShardSpec]:
    """A :class:`ShardSpec`, or None where there is nothing to shard over
    (no mesh, another axis, or one rank)."""
    mesh = mesh if mesh is not None else default_mesh()
    if mesh is None:
        return None
    if axis is None:
        axis = embedding_axis(mesh)
    if axis not in mesh.axis_names or mesh.size <= 1:
        return None
    rps = -(-int(vocab) // mesh.size)
    return ShardSpec(mesh=mesh, axis=axis, shards=mesh.size,
                     rows_per_shard=rps, vocab=int(vocab), dim=int(dim))


def can_run(spec: Optional[ShardSpec], n_ids: int) -> bool:
    """Whether a lookup of ``n_ids`` ids over the whole batch (all ranks)
    takes the sharded path: the count must divide over the shards. In the
    port every rank holds an equal share of each batch, so it always does."""
    return (spec is not None and spec.shards > 1
            and n_ids >= spec.shards and n_ids % spec.shards == 0)


# -- byte counters ----------------------------------------------------------------

#: bytes this process sent and received in the sharded exchanges: the
#: forward's ids and rows (``exchange``) and the backward's gradients
#: (``grad``). Summed over the ranks they are the JAX package's
#: ``embed.exchange_bytes_total`` and ``embed.grad_bytes_total``.
exchange_bytes = {"exchange": 0, "grad": 0}
#: ``{table name: global padded bytes}`` of the sharded tables built in
#: this process (the JAX package's ``embed.table_bytes`` gauge is the sum)
table_bytes: Dict[str, int] = {}


def reset_exchange_bytes() -> None:
    exchange_bytes["exchange"] = 0
    exchange_bytes["grad"] = 0


def note_table_bytes(key: str, nbytes: int) -> None:
    table_bytes[key] = int(nbytes)


def exchange_cost_bytes(spec: ShardSpec, n_ids: int) -> Dict[str, float]:
    """Bytes one lookup and its gradient of ``n_ids`` ids (the whole batch,
    all ranks) move, summed over the ranks: forward ids and rows, backward
    gradients, and what an all-reduce of the dense table gradient would
    move instead."""
    n_loc = max(n_ids // spec.shards, 1)
    fwd = spec.shards * 2 * spec.shards * n_loc * (4 + spec.dim * 4)
    bwd = spec.shards * 2 * spec.shards * n_loc * spec.dim * 4
    return {"forward_bytes": float(fwd), "grad_bytes": float(bwd),
            "dense_grad_bytes": float(spec.padded * spec.dim * 4
                                      * spec.mesh.size)}


# -- per-rank bodies --------------------------------------------------------------


def _routing(spec: ShardSpec, ids: torch.Tensor):
    """Sorted uniques of ``ids`` filled to ``n`` with the SENTINEL (JAX's
    ``jnp.unique(size=n, fill_value=padded, return_inverse=True)``), the
    inverse map, each unique's owning rank ``d``, its row there, and its
    slot in the request block for that rank. A sort, a first-of-run flag
    and a cumsum: no host sync and no shape that depends on the data, which
    ``torch.unique`` on the card would have."""
    n = ids.shape[0]
    ids = ids.to(torch.int64)
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    pos = torch.cumsum(first, 0) - 1
    u = torch.full((n,), spec.padded, dtype=torch.int64, device=ids.device)
    u[pos] = sorted_ids  # the members of a run write the same value
    inv = torch.empty(n, dtype=torch.int64, device=ids.device)
    inv[order] = pos
    d = torch.clamp(u // spec.rows_per_shard, max=spec.shards - 1)
    local_row = (u - d * spec.rows_per_shard).to(torch.int32)
    starts = torch.searchsorted(
        d, torch.arange(spec.shards, device=ids.device))
    slot = torch.arange(n, device=ids.device) - starts[d]
    return u, inv, d, local_row, slot


def _lookup_body(spec: ShardSpec, tshard: torch.Tensor, ids: torch.Tensor):
    """Forward on one rank: unique, id exchange, local gather, row exchange,
    undup. Returns ``(rows [n, dim], recv [shards, n])``: ``recv`` holds the
    local rows other ranks asked this rank for (SENTINEL ``rows_per_shard``
    where nothing was asked), for the backward and the row update."""
    n, mesh = ids.shape[0], spec.mesh
    _u, inv, d, local_row, slot = _routing(spec, ids)
    req = torch.full((spec.shards, n), spec.rows_per_shard,
                     dtype=torch.int32, device=ids.device)
    req[d, slot] = local_row
    recv = mesh.all_to_all(req)
    rows = _ek.gather_rows(tshard, recv.reshape(-1))
    back = mesh.all_to_all(rows.reshape(spec.shards, n, spec.dim))
    exchange_bytes["exchange"] += 2 * spec.shards * n * (
        4 + spec.dim * tshard.element_size())
    return back[d, slot][inv], recv


def _lookup_bwd_body(spec: ShardSpec, g: torch.Tensor, ids: torch.Tensor,
                     recv: torch.Tensor) -> torch.Tensor:
    """Backward on one rank: sum the cotangent per unique, send each sum to
    its owner, and scatter-add what arrives into this rank's block (the
    SENTINEL rows drop)."""
    n = ids.shape[0]
    _u, inv, d, _local_row, slot = _routing(spec, ids)
    g_req = _ek.segment_grads(g.contiguous(), inv, d, slot, spec.shards)
    g_recv = spec.mesh.all_to_all(g_req)
    exchange_bytes["grad"] += 2 * spec.shards * n * spec.dim * 4
    return _ek.scatter_rows(g_recv.reshape(spec.shards * n, spec.dim),
                            recv.reshape(-1), spec.rows_per_shard)


class _ShardedLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, flat_ids, spec):
        out, recv = _lookup_body(spec, table, flat_ids)
        ctx.spec = spec
        ctx.save_for_backward(flat_ids, recv)
        ctx.mark_non_differentiable(recv)
        return out, recv

    @staticmethod
    def backward(ctx, g_out, _g_recv):
        flat_ids, recv = ctx.saved_tensors
        return _lookup_bwd_body(ctx.spec, g_out, flat_ids, recv), None, None


def sharded_lookup(table: torch.Tensor, flat_ids: torch.Tensor,
                   spec: ShardSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """``table[flat_ids]`` from a vocab-sharded table: ``table`` is this
    rank's block ``[rows_per_shard, dim]`` and ``flat_ids`` this rank's
    global ids ``[n]`` (``spec.padded`` is the SENTINEL: a zero row, no
    gradient). Returns ``(rows [n, dim], recv)``; feed ``recv`` to
    :func:`apply_row_update`. Differentiable in ``table``: the gradient is
    this rank's ``[rows_per_shard, dim]`` block. A collective: every rank
    calls it, and runs its backward, in the same order."""
    return _ShardedLookup.apply(table, flat_ids.contiguous(), spec)


# -- sparse row-subset optimizer updates -----------------------------------------


def init_row_state(kind: str, table: torch.Tensor) -> Dict[str, Any]:
    """Row-wise optimizer state for one table block, as the optax init of
    ``kind`` (adagrad: initial accumulator 0.1)."""
    with torch.no_grad():
        if kind == "sgd":
            return {}
        if kind == "adagrad":
            return {"acc": torch.full_like(table, 0.1)}
        if kind == "adam":
            return {"mu": torch.zeros_like(table),
                    "nu": torch.zeros_like(table),
                    "count": torch.zeros((), dtype=torch.int32,
                                         device=table.device)}
    raise ValueError(f"no sparse row update for optimizer kind {kind!r}")


def _put_rows(dst: torch.Tensor, flat: torch.Tensor, ok: torch.Tensor,
              vals: torch.Tensor) -> None:
    """``dst[flat[j]] = vals[j]`` for every ``j`` with ``ok[j]``, dropping
    the rest (JAX's ``.at[].set(mode="drop")``) without reading a count on
    the host: a dropped entry writes the last row with the value that row
    ends with, so every write to a row is the same value. Rows asked for
    twice carry equal values, as in the JAX package."""
    last = dst.shape[0] - 1
    hit = ok & (flat == last)
    keep = torch.where(hit.any(), vals[hit.to(torch.int8).argmax()],
                       dst[last])
    dst.index_put_((torch.where(ok, flat, last),),
                   torch.where(ok[:, None], vals, keep))


def apply_row_update(kind: str, hyper: Dict[str, float], spec: ShardSpec,
                     table: torch.Tensor, grad_ct: torch.Tensor,
                     recv: torch.Tensor, row_state: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """Update, in place, only the rows of this rank's block that ``recv``
    names (and their optimizer state) from the block's cotangent
    ``grad_ct``, with the optax arithmetic of ``kind`` in the JAX package's
    order (``_update_body``). Returns the new row state."""
    if kind not in ("sgd", "adagrad", "adam"):
        raise ValueError(f"no sparse row update for optimizer kind {kind!r}")
    flat = recv.reshape(-1).to(torch.int64)
    ok = (flat >= 0) & (flat < spec.rows_per_shard)
    safe = flat.clamp(0, spec.rows_per_shard - 1)
    lr = hyper["lr"]
    with torch.no_grad():
        t_rows = table[safe]
        g_rows = grad_ct[safe]
        if kind == "sgd":
            _put_rows(table, flat, ok, (t_rows + (-lr) * g_rows)
                      .to(table.dtype))
            return {}
        if kind == "adagrad":
            acc = row_state["acc"]
            nu = g_rows * g_rows + acc[safe]
            inv_rt = torch.where(nu > 0, torch.rsqrt(nu + hyper["eps"]),
                                 torch.zeros_like(nu))
            _put_rows(table, flat, ok, (t_rows + (-lr) * (inv_rt * g_rows))
                      .to(table.dtype))
            _put_rows(acc, flat, ok, nu.to(acc.dtype))
            return {"acc": acc}
        # lazy adam: moments of the touched rows only, one global count
        mu, nu, count = row_state["mu"], row_state["nu"], row_state["count"]
        b1, b2 = hyper["b1"], hyper["b2"]
        new_mu = (1.0 - b1) * g_rows + b1 * mu[safe]
        new_nu = (1.0 - b2) * (g_rows * g_rows) + b2 * nu[safe]
        new_count = torch.where(count < torch.iinfo(torch.int32).max,
                                count + 1, count)
        c = new_count.to(g_rows.dtype)
        mu_hat = new_mu / (1.0 - torch.pow(b1, c))
        nu_hat = new_nu / (1.0 - torch.pow(b2, c))
        step = (-lr) * (mu_hat / (torch.sqrt(nu_hat) + hyper["eps"]))
        _put_rows(table, flat, ok, (t_rows + step).to(table.dtype))
        _put_rows(mu, flat, ok, new_mu.to(mu.dtype))
        _put_rows(nu, flat, ok, new_nu.to(nu.dtype))
        return {"mu": mu, "nu": nu, "count": new_count}


def apply_dense_update(kind: str, hyper: Dict[str, float],
                       table: torch.Tensor, grad: torch.Tensor,
                       row_state: Dict[str, Any]) -> Dict[str, Any]:
    """The arithmetic of :func:`apply_row_update` on every row of the block,
    in place: the update for a step whose lookup left no ``recv``."""
    lr = hyper["lr"]
    with torch.no_grad():
        if kind == "sgd":
            table.copy_((table + (-lr) * grad).to(table.dtype))
            return {}
        if kind == "adagrad":
            acc = row_state["acc"]
            nu = grad * grad + acc
            inv_rt = torch.where(nu > 0, torch.rsqrt(nu + hyper["eps"]),
                                 torch.zeros_like(nu))
            table.copy_((table + (-lr) * (inv_rt * grad)).to(table.dtype))
            acc.copy_(nu)
            return {"acc": acc}
        if kind == "adam":
            mu, nu = row_state["mu"], row_state["nu"]
            count = row_state["count"]
            b1, b2 = hyper["b1"], hyper["b2"]
            mu.copy_((1.0 - b1) * grad + b1 * mu)
            nu.copy_((1.0 - b2) * (grad * grad) + b2 * nu)
            new_count = torch.where(count < torch.iinfo(torch.int32).max,
                                    count + 1, count)
            c = new_count.to(grad.dtype)
            mu_hat = mu / (1.0 - torch.pow(b1, c))
            nu_hat = nu / (1.0 - torch.pow(b2, c))
            table.add_((-lr) * (mu_hat / (torch.sqrt(nu_hat)
                                          + hyper["eps"])))
            return {"mu": mu, "nu": nu, "count": new_count}
    raise ValueError(f"no sparse row update for optimizer kind {kind!r}")
