"""Greedy and n-gram speculative generation: the port against the JAX
package, token for token, on the cases of the JAX package's own spec-decode
tests (cold and primed history, budget clip, EOS, ring wraparound, and the
trigram / bigram / no-match drafts)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny
from videollm_online_tpu.models import generate as jax_gen
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import generate as gen
from videollm_online_tpu_torch.models import llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxTokenizer(JaxBytes(), jax_tiny()).cfg
    cfg = LiveTokenizer(ByteTokenizer(), tiny_live_config()).cfg
    jparams = jax_live.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_numpy(jax.device_get(jparams),
                                                 device="cpu")


def _jax_run(jcfg, jparams, ids, max_new, spec, hist_ids=()):
    cache = jax_llama.init_kv_cache(jcfg.llama, batch=1, capacity=256)
    emb = jax_llama.embed_tokens(jparams["llama"],
                                 jnp.asarray([ids], jnp.int32), jcfg.llama)
    nv = jnp.asarray([len(ids)], jnp.int32)
    if not spec:
        out, length, cache = jax_gen.greedy_generate(
            jparams, jcfg, cache, emb, nv, max_new_tokens=max_new)
        return np.asarray(out)[0], int(length[0]), int(cache.offset[0]), None
    hist = jnp.zeros((jax_gen.SPEC_HIST,), jnp.int32)
    hc = jnp.asarray(0, jnp.int32)
    if len(hist_ids):
        hist, hc = jax_gen.hist_append_ids(
            hist, hc, jnp.asarray(hist_ids, jnp.int32),
            jnp.asarray(len(hist_ids), jnp.int32))
    out, length, cache, hist, hc, stats = jax_gen.ngram_speculative_generate(
        jparams, jcfg, cache, emb, nv, hist, hc,
        prompt_ids=jnp.asarray(ids, jnp.int32),
        prompt_n=jnp.asarray(len(ids), jnp.int32), max_new_tokens=max_new,
        draft_mode=spec)
    return (np.asarray(out)[0], int(length[0]), int(cache.offset[0]),
            (np.asarray(hist), int(hc), np.asarray(stats)))


def _port_run(cfg, params, ids, max_new, spec, hist_ids=()):
    cache = llama.init_kv_cache(cfg.llama, batch=1, capacity=256,
                                device="cpu")
    emb = llama.embed_tokens(params["llama"], torch.tensor([ids]), cfg.llama)
    if not spec:
        out, length, cache = gen.greedy_generate(
            params, cfg, cache, emb, [len(ids)], max_new_tokens=max_new)
        return out.numpy()[0], int(length[0]), int(cache.offset[0]), None
    hist = torch.zeros((gen.SPEC_HIST,), dtype=torch.int32)
    hc = torch.tensor(0, dtype=torch.int32)
    if len(hist_ids):
        hist, hc = gen.hist_append_ids(hist, hc, torch.tensor(hist_ids),
                                       len(hist_ids))
    out, length, cache, hist, hc, stats = gen.ngram_speculative_generate(
        params, cfg, cache, emb, [len(ids)], hist, hc,
        prompt_ids=torch.tensor(ids), prompt_n=len(ids),
        max_new_tokens=max_new, draft_mode=spec)
    return (out.numpy()[0], int(length[0]), int(cache.offset[0]),
            (hist.numpy(), int(hc), stats.numpy()))


def _assert_same(got, want):
    (g_out, g_len, g_off, g_spec), (w_out, w_len, w_off, w_spec) = got, want
    assert g_len == w_len
    np.testing.assert_array_equal(g_out[:g_len], w_out[:w_len])
    assert g_off == w_off
    if w_spec is not None:
        np.testing.assert_array_equal(g_spec[0], w_spec[0])   # history ring
        assert g_spec[1] == w_spec[1]
        np.testing.assert_array_equal(g_spec[2], w_spec[2])   # [steps, emitted]


def _ids(cfg, seed, n):
    rng = np.random.RandomState(seed)
    return [int(i) for i in rng.randint(0, cfg.llama.vocab_size, n)]


@pytest.mark.parametrize("mode", [None, "ngram", "zero"],
                         ids=["greedy", "ngram", "zero"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cold_history_matches_jax(setup, seed, mode):
    jcfg, jparams, cfg, params = setup
    ids = _ids(cfg, seed, 9)
    want = _jax_run(jcfg, jparams, ids, 24, mode)
    _assert_same(_port_run(cfg, params, ids, 24, mode), want)
    if mode:   # and the spec stream is the greedy stream
        _assert_same(_port_run(cfg, params, ids, 24, None)[:3] + (None,),
                     want[:3] + (None,))


def test_primed_history_matches_jax(setup):
    """The previous identical turn in the history: drafts are accepted, and
    the port takes the same verify steps as JAX."""
    jcfg, jparams, cfg, params = setup
    ids = _ids(cfg, 3, 9)
    g_out, g_len, _, _ = _port_run(cfg, params, ids, 32, None)
    prior = ids + [int(t) for t in g_out[:g_len]]
    want = _jax_run(jcfg, jparams, ids, 32, "ngram", hist_ids=prior)
    got = _port_run(cfg, params, ids, 32, "ngram", hist_ids=prior)
    _assert_same(got, want)
    steps, emitted = got[3][2]
    assert steps < emitted == g_len


@pytest.mark.parametrize("max_new", [1, 3, 5])
@pytest.mark.parametrize("mode", [None, "ngram"], ids=["greedy", "ngram"])
def test_budget_clip_matches_jax(setup, max_new, mode):
    jcfg, jparams, cfg, params = setup
    ids = _ids(cfg, 4, 7)
    want = _jax_run(jcfg, jparams, ids, max_new, mode)
    got = _port_run(cfg, params, ids, max_new, mode)
    _assert_same(got, want)
    assert got[1] <= max_new


@pytest.mark.parametrize("mode", [None, "ngram"], ids=["greedy", "ngram"])
def test_eos_matches_jax(setup, mode):
    """EOS set to a token the model emits mid-stream; the history holds the
    full stream so the drafts contain the EOS."""
    jcfg, jparams, cfg, params = setup
    ids = _ids(cfg, 5, 8)
    g_out, g_len, _, _ = _port_run(cfg, params, ids, 24, None)
    assert g_len >= 4
    eos = int(g_out[3])
    jcfg, cfg = jcfg.replace(eos_token_id=eos), cfg.replace(eos_token_id=eos)
    prior = ids + [int(t) for t in g_out[:g_len]]
    want = _jax_run(jcfg, jparams, ids, 24, mode, hist_ids=prior)
    got = _port_run(cfg, params, ids, 24, mode, hist_ids=prior)
    _assert_same(got, want)
    assert got[0][got[1] - 1] == eos


def test_hist_ring_wraparound_matches_jax():
    jh, jc = jnp.zeros((8,), jnp.int32), jnp.asarray(0, jnp.int32)
    h, c = torch.zeros((8,), dtype=torch.int32), torch.tensor(0)
    for ids, n in (([1, 2, 3, 4, 5], 5), ([6, 7, 8, 9, 0, 0], 4)):
        jh, jc = jax_gen.hist_append_ids(jh, jc, jnp.asarray(ids),
                                         jnp.asarray(n, jnp.int32))
        h, c = gen.hist_append_ids(h, c, torch.tensor(ids), n)
    assert int(c) == int(jc) == 9
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(h.numpy(), [9, 2, 3, 4, 5, 6, 7, 8])


DRAFTS = {
    # the most recent trigram match (C -> Y) wins over any bigram match
    "trigram": ([10, 11, 12, 77, 5, 10, 11, 12, 88, 99, 6, 10, 11, 12], 3,
                [88, 99, 6]),
    "bigram": ([1, 20, 21, 42, 43, 9, 20, 21], 2, [42, 43]),
    "no_match": ([1, 2, 3, 4, 5, 6], 4, [0, 0, 0, 0]),
    # a match near the end: drafts past the newest token are zero
    "short_tail": ([7, 8, 9, 7, 8], 4, [9, 7, 8, 0]),
}


@pytest.mark.parametrize("name", sorted(DRAFTS))
@pytest.mark.parametrize("ring", [64, 8], ids=["ring64", "ring8"])
def test_ngram_draft_matches_jax(name, ring):
    seq, k, expected = DRAFTS[name]
    jh, jc = jax_gen.hist_append_ids(
        jnp.zeros((ring,), jnp.int32), jnp.asarray(0, jnp.int32),
        jnp.asarray(seq, jnp.int32), jnp.asarray(len(seq), jnp.int32))
    h, c = gen.hist_append_ids(torch.zeros((ring,), dtype=torch.int32),
                               torch.tensor(0), torch.tensor(seq), len(seq))
    got = gen._ngram_draft(h, c, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_gen._ngram_draft(jh, jc, k)))
    if ring >= len(seq):
        np.testing.assert_array_equal(got, expected)
