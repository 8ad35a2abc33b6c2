"""The port's decoder against the JAX package's ``llama.forward``.

The same fp32 weights (made by the JAX package, carried over with
``params_from_numpy``) and the same ids go through both; the cases are
those of the JAX decoder's own parity tests: a full forward, a prefill
followed by token-by-token decode, and a bucket-padded append with
``num_valid`` and gathered logits. int8 weights: the codes are
bit-identical to ``quant.quantize_weight`` and a q8 forward agrees.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core.config import LoraConfig as JaxLoraConfig
from videollm_online_tpu.core.config import tiny_llama_config as jax_tiny
from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_live
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.models import quant as jax_quant

from videollm_online_tpu_torch.core.config import tiny_llama_config
from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import live, llama, quant
from videollm_online_tpu_torch.models.bridge import params_from_numpy

ATOL = 1e-5      # fp32 weights, fp32 activations
ATOL_Q8 = 1e-4   # int8 weights: the per-channel scale multiplies a larger sum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_tiny()
    jparams = jax.device_get(jax_llama.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    return jcfg, jparams, tiny_llama_config(), params_from_numpy(
        jparams, device="cpu")


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def test_full_forward_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 17))
    want, _ = jax_llama.forward(jparams, cfg=jcfg, input_ids=jnp.asarray(ids))
    got, cache = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids))
    assert cache is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_prefill_then_decode_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    T = 13
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(1, T))
    jcache = jax_llama.init_kv_cache(jcfg, batch=1, capacity=32,
                                     dtype=jnp.float32)
    cache = llama.init_kv_cache(cfg, batch=1, capacity=32, device="cpu")
    want, jcache = jax_llama.forward(jparams, cfg=jcfg,
                                     input_ids=jnp.asarray(ids[:, :7]),
                                     kv_cache=jcache)
    got, cache = llama.forward(params, cfg=cfg,
                               input_ids=torch.tensor(ids[:, :7]),
                               kv_cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    for t in range(7, T):
        want, jcache = jax_llama.forward(
            jparams, cfg=jcfg, input_ids=jnp.asarray(ids[:, t:t + 1]),
            kv_cache=jcache)
        got, cache = llama.forward(params, cfg=cfg,
                                   input_ids=torch.tensor(ids[:, t:t + 1]),
                                   kv_cache=cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    assert int(cache.offset[0]) == int(jcache.offset[0]) == T
    # the ring holds the same K/V (in place in the port)
    np.testing.assert_allclose(_np(cache.k[:, :, :, :T]),
                               np.asarray(jcache.k[:, :, :, :T]), atol=ATOL)


@pytest.mark.parametrize("gather", ["last_valid", "grouped", "last_logit"])
def test_bucket_padded_append_matches_jax(pair, gather):
    """6 valid tokens in a bucket of 8, then the rest: the padding past the
    end is never attended and the next append overwrites it."""
    jcfg, jparams, cfg, params = pair
    ids = np.random.RandomState(2).randint(0, cfg.vocab_size, size=(2, 10))
    bucket = np.concatenate([ids[:, :6], np.full((2, 2), 7)], axis=1)
    nv = np.array([6, 5], np.int32)
    kw_j, kw_t = {}, {}
    if gather == "last_valid":
        kw_j["logit_gather_positions"] = jnp.asarray(nv - 1)
        kw_t["logit_gather_positions"] = torch.tensor(nv - 1)
    elif gather == "grouped":
        pos = np.array([[0, 2, 5], [1, 3, 4]], np.int32)
        kw_j["logit_gather_positions"] = jnp.asarray(pos)
        kw_t["logit_gather_positions"] = torch.tensor(pos)
    else:
        kw_j["last_logit_only"] = kw_t["last_logit_only"] = True
    jcache = jax_llama.init_kv_cache(jcfg, batch=2, capacity=64,
                                     dtype=jnp.float32)
    cache = llama.init_kv_cache(cfg, batch=2, capacity=64, device="cpu")
    want, jcache = jax_llama.forward(
        jparams, cfg=jcfg, input_ids=jnp.asarray(bucket), kv_cache=jcache,
        num_valid=jnp.asarray(nv), **kw_j)
    got, cache = llama.forward(params, cfg=cfg, input_ids=torch.tensor(bucket),
                               kv_cache=cache, num_valid=torch.tensor(nv),
                               **kw_t)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(_np(cache.offset), [6, 5])
    want, jcache = jax_llama.forward(jparams, cfg=jcfg,
                                     input_ids=jnp.asarray(ids[:, 6:]),
                                     kv_cache=jcache)
    got, cache = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids[:, 6:]),
                               kv_cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(_np(cache.offset), np.asarray(jcache.offset))


def test_ring_write_clamps_like_dynamic_update_slice(pair):
    """An append that would run past the ring starts at C - S instead, as
    ``jax.lax.dynamic_update_slice`` clamps its start."""
    jcfg, jparams, cfg, params = pair
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, size=(1, 4))
    jcache = jax_llama.init_kv_cache(jcfg, batch=1, capacity=8,
                                     dtype=jnp.float32)
    jcache = jcache._replace(offset=jnp.asarray([6], jnp.int32))
    cache = llama.init_kv_cache(cfg, batch=1, capacity=8, device="cpu")
    cache = llama.trim_kv_cache(cache, 6)
    want, jcache = jax_llama.forward(jparams, cfg=jcfg,
                                     input_ids=jnp.asarray(ids),
                                     kv_cache=jcache)
    got, cache = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids),
                               kv_cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(_np(cache.k), np.asarray(jcache.k), atol=ATOL)


def test_lora_forward_matches_jax():
    """The inference LoRA branch (no dropout) on every target and the head."""
    jcfg = jax_tiny_live()
    jparams = jax_live.init_params(jax.random.PRNGKey(4), jcfg)
    jparams["lora"] = jax.tree.map(lambda x: x + 0.01, jparams["lora"])
    jparams = jax.device_get(jparams)
    params = params_from_numpy(jparams, device="cpu")
    cfg = tiny_live_config()
    ids = np.random.RandomState(4).randint(0, cfg.llama.vocab_size, (1, 9))
    scaling = JaxLoraConfig(r=4, alpha=8).scaling
    assert scaling == cfg.lora.scaling
    want, _ = jax_llama.forward(jparams["llama"], cfg=jcfg.llama,
                                input_ids=jnp.asarray(ids),
                                lora=jparams["lora"], lora_scaling=scaling)
    got, _ = llama.forward(params["llama"], cfg=cfg.llama,
                           input_ids=torch.tensor(ids), lora=params["lora"],
                           lora_scaling=scaling)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_connector_matches_jax():
    jcfg = jax_tiny_live()
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(5),
                                                  jcfg))
    params = params_from_numpy(jparams, device="cpu")
    feats = np.random.RandomState(5).randn(
        3, jcfg.frame_num_tokens, jcfg.vision_hidden_size).astype(np.float32)
    want = jax_live.visual_embed(jparams, jnp.asarray(feats), jcfg)
    got = live.visual_embed(params, torch.from_numpy(feats),
                            tiny_live_config())
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("axis,shape", [(0, (48, 40)), (1, (40, 48)),
                                        (-2, (2, 48, 40))])
def test_quantize_weight_codes_bit_identical(axis, shape):
    w = np.random.RandomState(6).randn(*shape).astype(np.float32)
    w[..., 3] = 0.0                           # an all-zero channel: scale 1
    want = jax_quant.quantize_weight(jnp.asarray(w), axis=axis)
    got = quant.quantize_weight(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(_np(got["q8"]), np.asarray(want["q8"]))
    np.testing.assert_array_equal(_np(got["scale"]), np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        _np(quant.dequantize_weight(got, axis=axis, dtype=torch.float32)),
        np.asarray(jax_quant.dequantize_weight(want, axis=axis,
                                               dtype=jnp.float32)))


def test_q8_forward_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    jq = jax.device_get(jax_quant.quantize_llama_params(jparams))
    q = quant.quantize_llama_params(params)
    for name, leaf in q["layers"].items():
        if isinstance(leaf, dict):
            np.testing.assert_array_equal(_np(leaf["q8"]),
                                          jq["layers"][name]["q8"])
    np.testing.assert_array_equal(_np(q["embed"]["q8"]), jq["embed"]["q8"])
    ids = np.random.RandomState(7).randint(0, cfg.vocab_size, size=(1, 12))
    jcache = jax_llama.init_kv_cache(jcfg, batch=1, capacity=16,
                                     dtype=jnp.float32)
    cache = llama.init_kv_cache(cfg, batch=1, capacity=16, device="cpu")
    want, _ = jax_llama.forward(jq, cfg=jcfg, input_ids=jnp.asarray(ids),
                                kv_cache=jcache)
    got, _ = llama.forward(params_from_numpy(jq, device="cpu"), cfg=cfg,
                           input_ids=torch.tensor(ids), kv_cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL_Q8)
    got_q, _ = llama.forward(q, cfg=cfg, input_ids=torch.tensor(ids))
    np.testing.assert_allclose(_np(got_q), np.asarray(want), atol=ATOL_Q8)


def test_random_quantized_params_match_jax_layout():
    """Same tree, shapes, dtypes and scales as the JAX package's
    ``random_quantized_llama_params``; the codes are drawn by another
    generator."""
    cfg = tiny_llama_config()
    jtree = jax.device_get(jax_quant.random_quantized_llama_params(
        jax.random.PRNGKey(0), jax_tiny()))
    tree = quant.random_quantized_llama_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), path
        if path.endswith("scale") or "norm" in path:
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       rtol=1e-6, err_msg=path)

    walk(tree, jtree)
    assert quant.param_bytes(tree) == jax_quant.param_bytes(jtree)


def test_entry_points_need_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_kv_cache(tiny_llama_config(), batch=1, capacity=8)
