"""The torch port's decode ops (``ops/decode.py``) against the JAX
package's on the CPU: the slot caches, the paged pools (f32 and int8), the
logit filter, the sampled selector and beam search.

Inputs come from numpy seeds and cross as numpy arrays. The port writes
its caches in place and JAX returns new arrays; each test compares what
both hold afterwards. Cache contents, int8 codes and scales are held bit
for bit, attention contexts within 1e-6, filtered logits within 1e-6 with
their masks exact, beam scores within 1e-5 and tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.ops import decode as jd
from analytics_zoo_tpu_torch.ops import decode as pd
from torch_port_threads import torch_threads_per_worker  # noqa: F401

S, H, L, D = 4, 3, 32, 8  # slots, heads, max_len, head_dim


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _same(jax_tree, torch_tree):
    for key, want in jax_tree.items():
        np.testing.assert_array_equal(torch_tree[key].numpy(),
                                      np.asarray(want), err_msg=key)


# -- slot caches ----------------------------------------------------------------


def test_slot_state_join_and_evict_match_jax():
    jstate, pstate = jd.init_slot_state(S), pd.init_slot_state(S)
    _same(jstate, pstate)
    for slot, length in ((1, 5), (3, 0), (0, 9)):
        jstate = jd.slot_join(jstate, slot, length)
        assert pd.slot_join(pstate, slot, length) is pstate
        _same(jstate, pstate)
    mask = np.array([True, False, False, True])
    jstate = jd.slot_evict(jstate, mask)
    assert pd.slot_evict(pstate, _t(mask)) is pstate
    _same(jstate, pstate)
    assert pstate["length"].dtype == torch.int32


@pytest.mark.parametrize("t", [1, 7, 16])
def test_slot_insert_matches_jax(t):
    rs = np.random.RandomState(t)
    jc = jd.init_slot_cache(S, H, L, D)
    pc = pd.init_slot_cache(S, H, L, D)
    for slot in (2, 0):
        k, v = _rand(rs, H, t, D), _rand(rs, H, t, D)
        jc = jd.slot_insert(jc, slot, jnp.asarray(k), jnp.asarray(v))
        assert pd.slot_insert(pc, slot, _t(k), _t(v)) is pc
    _same(jc, pc)


def test_slot_attention_matches_jax():
    rs = np.random.RandomState(1)
    jc = jd.init_slot_cache(S, H, L, D)
    pc = pd.init_slot_cache(S, H, L, D)
    pre_k, pre_v = _rand(rs, S, H, L, D), _rand(rs, S, H, L, D)
    jc = {"k": jnp.asarray(pre_k), "v": jnp.asarray(pre_v)}
    pc = {"k": _t(pre_k), "v": _t(pre_v)}
    # a fresh slot, two mid-stream, and one at the buffer's last position
    lengths = np.array([0, 5, 17, L - 1], np.int32)
    for _ in range(2):
        q, k, v = (_rand(rs, S, H, 1, D) for _ in range(3))
        jctx, jc = jd.slot_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jc, jnp.asarray(lengths))
        pctx, pc2 = pd.slot_attention(_t(q), _t(k), _t(v), pc, _t(lengths))
        assert pc2 is pc
        np.testing.assert_allclose(pctx.numpy(), np.asarray(jctx), rtol=0,
                                   atol=1e-6)
        _same(jc, pc)
        lengths = np.minimum(lengths + 1, L - 1)


# -- paged pools ----------------------------------------------------------------


P, PL, W = 12, 4, 8  # pages, page_len, table width (W·PL = L)


def test_init_paged_pool_matches_jax():
    for int8 in (False, True):
        _same(jd.init_paged_pool(P, H, PL, D, int8=int8),
              pd.init_paged_pool(P, H, PL, D, int8=int8))
    with pytest.raises(ValueError, match="null page"):
        pd.init_paged_pool(1, H, PL, D)


def test_page_tables_and_positions_match_jax():
    rs = np.random.RandomState(2)
    table = rs.randint(1, P, (S, W)).astype(np.int32)
    positions = rs.randint(0, L + 2 * PL, (S, 5)).astype(np.int32)
    jpage, joff = jd._page_positions(jnp.asarray(table),
                                     jnp.asarray(positions), PL)
    ppage, poff = pd._page_positions(_t(table), _t(positions), PL)
    np.testing.assert_array_equal(ppage.numpy(), np.asarray(jpage))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    row = rs.randint(1, P, (W,)).astype(np.int32)
    jt = jd.page_table_set(jnp.asarray(table), 2, jnp.asarray(row))
    pt = _t(table)
    assert pd.page_table_set(pt, 2, _t(row)) is pt
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    mask = np.array([False, True, True, False])
    jt = jd.page_table_clear(jt, mask)
    pd.page_table_clear(pt, _t(mask))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))


def _pools(int8, rs):
    """The same pool on both sides, its pages filled through one insert."""
    jc = jd.init_paged_pool(P, H, PL, D, int8=int8)
    pc = pd.init_paged_pool(P, H, PL, D, int8=int8)
    row = np.array([3, 7, 1, 9, 0, 0, 0, 0], np.int32)
    k, v = _rand(rs, H, 13, D) * 3, _rand(rs, H, 13, D)
    jc = jd.paged_insert(jc, jnp.asarray(row), jnp.asarray(k),
                         jnp.asarray(v))
    pd.paged_insert(pc, _t(row), _t(k), _t(v))
    return jc, pc, row


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("start", [0, 6])
def test_paged_insert_matches_jax_bit_for_bit(int8, start):
    rs = np.random.RandomState(3 + start)
    jc, pc, row = _pools(int8, rs)
    k, v = _rand(rs, H, 9, D) * 5, _rand(rs, H, 9, D)  # past the row's pages
    jc = jd.paged_insert(jc, jnp.asarray(row), jnp.asarray(k),
                         jnp.asarray(v), start=start + 20)
    assert pd.paged_insert(pc, _t(row), _t(k), _t(v), start=start + 20) \
        is pc
    # page 0 (the null page) takes the writes past the allocation, in no
    # fixed order where two land on one position
    for key in pc:
        want, got = np.asarray(jc[key]), pc[key].numpy()
        if key in ("k", "v", "scale_k", "scale_v"):
            want, got = want[1:], got[1:]
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_page_copy_and_gather_match_jax(int8):
    rs = np.random.RandomState(4)
    jc, pc, row = _pools(int8, rs)
    jc = jd.page_copy(jc, 7, 5)
    assert pd.page_copy(pc, 7, 5) is pc
    _same(jc, pc)
    table = np.stack([row, np.roll(row, 1), row[::-1], np.zeros_like(row)])
    jk, jv = jd.paged_gather(jc, jnp.asarray(table))
    pk, pv = pd.paged_gather(pc, _t(table))
    assert pk.shape == (S, H, W * PL, D)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_attention_matches_jax(int8):
    rs = np.random.RandomState(5)
    jc, pc, row = _pools(int8, rs)
    table = np.zeros((S, W), np.int32)
    table[0] = row
    table[2, :3] = [2, 4, 6]
    lengths = np.array([13, 0, 9, 0], np.int32)
    for step in range(3):
        q, k, v = (_rand(rs, S, H, 1, D) for _ in range(3))
        jctx, jc = jd.paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
            jnp.asarray(table), jnp.asarray(lengths), L)
        pctx, _ = pd.paged_attention(_t(q), _t(k), _t(v), pc, _t(table),
                                     _t(lengths), L)
        active = lengths > 0  # inactive slots write to the null page
        np.testing.assert_allclose(pctx.numpy()[active],
                                   np.asarray(jctx)[active], rtol=0,
                                   atol=1e-6)
        for key in pc:
            want, got = np.asarray(jc[key]), pc[key].numpy()
            if key in ("k", "v", "scale_k", "scale_v"):
                want, got = want[1:], got[1:]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{key} step {step}")
        lengths = lengths + active


def test_slot_and_paged_attention_agree():
    """The paged step gives the contiguous step's context bit for bit."""
    rs = np.random.RandomState(6)
    sc = pd.init_slot_cache(S, H, L, D)
    pc = pd.init_paged_pool(S * W + 1, H, PL, D)
    table = torch.arange(1, S * W + 1, dtype=torch.int32).reshape(S, W)
    lengths = torch.tensor([0, 3, 11, 30], dtype=torch.int32)
    for _ in range(2):
        q, k, v = (_t(_rand(rs, S, H, 1, D)) for _ in range(3))
        want, _ = pd.slot_attention(q, k, v, sc, lengths)
        got, _ = pd.paged_attention(q, k, v, pc, table, lengths, L)
        assert torch.equal(got, want)
        lengths = lengths + 1


# -- selectors --------------------------------------------------------------


FILTERS = [(1.0, None, None), (0.7, 5, None), (1.3, None, 0.9),
           (0.8, 50, 0.9), (1.0, 1, None), (2.0, None, 1.0),
           (0.5, 200, 0.3)]


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_logit_filter_matches_jax(temperature, top_k, top_p):
    logits = _rand(np.random.RandomState(7), 6, 200) * 3
    logits[0, :10] = logits[0, 10]  # ties at the cut
    want = np.asarray(jd.make_logit_filter(temperature, top_k, top_p)(
        jnp.asarray(logits)))
    got = pd.make_logit_filter(temperature, top_k, top_p)(
        _t(logits)).numpy()
    masked = want <= -1e29
    np.testing.assert_array_equal(got <= -1e29, masked)
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=0,
                               atol=1e-6)


def test_logit_filter_refuses_what_jax_refuses():
    for kw in (dict(temperature=0.0), dict(top_k=0), dict(top_p=0.0),
               dict(top_p=1.5)):
        with pytest.raises(ValueError):
            jd.make_logit_filter(**kw)
        with pytest.raises(ValueError):
            pd.make_logit_filter(**kw)


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS[:4])
def test_sampled_select_on_jax_noise_equals_jax_categorical(temperature,
                                                            top_k, top_p):
    rs = np.random.RandomState(8)
    logits = _rand(rs, 5, 300) * 2
    filt_j = jd.make_logit_filter(temperature, top_k, top_p)(
        jnp.asarray(logits))
    filt_p = pd.make_logit_filter(temperature, top_k, top_p)(_t(logits))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, filt_j, axis=-1))
        noise = np.asarray(jax.random.gumbel(key, filt_j.shape))
        got = pd.sampled_select(filt_p, _t(noise)).numpy()
        np.testing.assert_array_equal(got, want)


def test_gumbel_noise_is_a_function_of_the_seed_and_prefix_stable():
    a = pd.gumbel_noise(11, (8, 1, 50))
    b = pd.gumbel_noise(11, (3, 50))
    assert torch.equal(a[:3, 0], b)
    assert not torch.equal(pd.gumbel_noise(12, (3, 50)), b)
    assert bool(torch.isfinite(a).all())


def _toy_step(table, token, cache):
    """A decode step with state, for JAX arrays and torch tensors alike:
    ``h = h/2 + table[token]``, whose logits are ``h``. The state's leading
    axis is the batch, so beam search tiles and reorders it."""
    h = cache["h"] * 0.5 + table[token]
    return h, {"h": h}


@pytest.mark.parametrize("beam,eos", [(2, None), (3, None), (4, 5)])
def test_beam_generate_matches_jax(beam, eos):
    rs = np.random.RandomState(9 + beam)
    v, b, steps = 16, 3, 6
    table = _rand(rs, v, v) * 2
    h0 = _rand(rs, b, v)
    last = rs.randint(0, v, (b,)).astype(np.int32)
    jseq, jscore = jd.beam_generate(_toy_step, jnp.asarray(table),
                                    {"h": jnp.asarray(h0)},
                                    jnp.asarray(last), steps, beam,
                                    eos_id=eos)
    pseq, pscore = pd.beam_generate(_toy_step, _t(table), {"h": _t(h0)},
                                    _t(last).long(), steps, beam, eos_id=eos)
    np.testing.assert_array_equal(pseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(pscore.numpy(), np.asarray(jscore), rtol=0,
                               atol=1e-5)
