"""Training's memory-fit mechanisms in the port against the JAX package's.

The tiny config, weights carried over by ``bridge.py``, inputs from numpy
seeds: the column-tiled int8 head (``quant.quantized_matmul`` with
``tile_cols``, ``head_tile_cols``) in the matmul, the chunked CE loss and
the evaluator; grouped remat (``remat_group``) and the sequence-sliced MLP
(``LlamaConfig.mlp_chunk``) against the plain step and against JAX's
``loss_fn``; the host-offloaded optimizer step (``train/offload.py``)
against the plain step and ``LiveTrainer(--offload_optimizer)`` against the
JAX trainer's offloaded run; ``OptimConfig.mu_dtype`` and the bf16 update
against optax.
"""

import dataclasses
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core import arguments as jax_arguments
from videollm_online_tpu.data import collator as jax_collator
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import quant as jax_quant
from videollm_online_tpu.train import optim as jax_optim
from videollm_online_tpu.train import step as jax_step
from videollm_online_tpu.train.trainer import LiveTrainer as JaxLiveTrainer

from videollm_online_tpu_torch.core import arguments
from videollm_online_tpu_torch.core.config import LoraConfig
from videollm_online_tpu_torch.data import collator
from videollm_online_tpu_torch.eval.stream_evaluate import StreamEvaluator
from videollm_online_tpu_torch.models import live, llama, quant
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.train import offload, optim
from videollm_online_tpu_torch.train import step as step_mod
from videollm_online_tpu_torch.train.trainer import LiveTrainer

from test_torch_train import (CONVERSATIONS, LOSS_TOL, _assert_tree_close,
                              _batch, _configs, _logged_losses, _sample,
                              _train_args)

# the tiled backward sums its tiles' fp32 partial products where the
# untiled one reduces all columns in one product: bf16 dX parts by a
# rounding (relative norm of the difference; bf16's unit roundoff 3.9e-3)
TILED_GRAD_REL = 4e-3
# a sliced MLP's LoRA gradients sum its slices' products in another order
CHUNK_GRAD_TOL = dict(rtol=3e-5, atol=3e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fit():
    """Tiny fp32 config with LoRA dropout 0.1, JAX params with non-zero
    LoRA B, and their bridged copy."""
    jcfg, jtok, cfg, tok = _configs(lora=LoraConfig(r=4, alpha=8,
                                                    dropout=0.1))
    jparams = jax_live.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    jparams["lora"] = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(rng.randn(*x.shape), x.dtype),
        jparams["lora"])
    jparams = jax.device_get(jparams)
    nb, tb = _batch(jtok, tok, CONVERSATIONS[:2], pad=64)
    return jcfg, jtok, cfg, tok, jparams, nb, tb


def _no_dropout(cfg):
    return dataclasses.replace(cfg, lora=dataclasses.replace(cfg.lora,
                                                             dropout=0.0))


def _port_grads(params, cfg, tb, **kw):
    state, frozen = step_mod.init_train_state(params)
    loss = step_mod.loss_fn(state.trainable, frozen, cfg, tb, **kw)
    return loss.detach(), torch.autograd.grad(
        loss, optim.tree_leaves(state.trainable))


def _hold_to_jax(got, jparams, jcfg, nb, **kw):
    """The port's (loss, gradient leaves) against JAX's loss_fn within
    test_torch_train.py's loss and gradient parity tolerances."""
    jtrain, jfrozen = jax_optim.split_trainable(jparams)
    loss, grads = jax.jit(jax.value_and_grad(jax_step.loss_fn),
                          static_argnums=2, static_argnames=tuple(kw))(
        jtrain, jfrozen, jcfg, {k: jnp.asarray(v) for k, v in nb.items()},
        **kw)
    np.testing.assert_allclose(float(got[0]), float(loss), **LOSS_TOL)
    trainable = optim.split_trainable(jparams)[0]
    _assert_tree_close(optim.tree_unflatten(trainable, got[1]),
                       jax.device_get(grads))


class _Casts:
    """Records the shape of every cast of int8 codes to a floating dtype
    (``torch.Tensor.to``) from now on: of ``of`` and its views only, when
    given."""

    def __init__(self, monkeypatch, of=None):
        self.shapes = []
        to = torch.Tensor.to
        ptr = None if of is None else of.untyped_storage().data_ptr()

        def spy(t, *a, **k):
            out = to(t, *a, **k)
            if t.dtype == torch.int8 and out.is_floating_point() and (
                    ptr is None or t.untyped_storage().data_ptr() == ptr):
                self.shapes.append(tuple(t.shape))
            return out
        monkeypatch.setattr(torch.Tensor, "to", spy)

    def widest(self):
        return max(s[-1] for s in self.shapes)


# ------------------------------------------------------------ tiled head
@pytest.mark.parametrize("v", [128256, 1024, 151936, 512])
def test_head_tile_cols_equals_jax(v):
    assert quant.head_tile_cols(v) == jax_quant.head_tile_cols(v)
    if v == 128256:
        assert quant.head_tile_cols(v) == 21376


@pytest.mark.parametrize("tile,dtype", [(128, torch.float32),
                                        (256, torch.bfloat16),
                                        (192, torch.float32)])
def test_quantized_matmul_tiled(tile, dtype, monkeypatch):
    """Bitwise the untiled int8 product on the CPU (a ragged last tile at
    192), within fp32 rounding of JAX's tiled product, and its gradient
    the untiled one's within TILED_GRAD_REL (bf16) or fp32 rounding; the
    backward keeps the codes and the scale and casts one tile at a time."""
    rng = np.random.RandomState(tile)
    w = rng.randn(64, 512).astype(np.float32)
    qw = quant.quantize_weight(torch.from_numpy(w), axis=0)
    x = torch.from_numpy(rng.randn(2, 8, 64).astype(np.float32)).to(dtype)
    ref = quant.quantized_matmul(x, qw)
    got = quant.quantized_matmul(x, qw, tile)
    assert got.dtype == dtype and torch.equal(got, ref)
    if dtype == torch.float32 and 512 % tile == 0:
        want = jax_quant.quantized_matmul_tiled(
            jnp.asarray(x.numpy()), jax_quant.quantize_weight(jnp.asarray(w)),
            tile)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    g = torch.from_numpy(rng.randn(2, 8, 512).astype(np.float32)).to(dtype)
    xr = x.clone().requires_grad_(True)
    (dref,) = torch.autograd.grad(quant.quantized_matmul(xr, qw), xr, g)
    casts = _Casts(monkeypatch)
    xt = x.clone().requires_grad_(True)
    out = quant.quantized_matmul(xt, qw, tile)
    assert [t.dtype for t in out.grad_fn.saved_tensors] == [torch.int8,
                                                             torch.float32]
    (dgot,) = torch.autograd.grad(out, xt, g)
    if dtype == torch.bfloat16:
        a, b = dgot.float(), dref.float()
        assert float((a - b).norm() / b.norm()) <= TILED_GRAD_REL
    else:
        np.testing.assert_allclose(dgot.numpy(), dref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert casts.shapes and casts.widest() <= tile


def test_chunked_loss_and_evaluator_cast_one_tile(fit, monkeypatch):
    """On an int8 tree with a head tile forced below the vocabulary, the
    chunked CE loss (and its gradients) and StreamEvaluator's outputs
    equal the untiled head's, and no call casts more than one tile of
    the head, forward or backward."""
    jcfg, jtok, cfg, tok, jparams, nb, tb = fit
    cfg = _no_dropout(cfg)
    V, tile = cfg.llama.vocab_size, 128
    params = params_from_numpy(dict(jparams, llama=jax.device_get(
        jax_quant.quantize_llama_params(jparams["llama"]))), device="cpu")
    kw = dict(chunked_loss=True, loss_chunk=32)
    batch = _batch(jtok, tok, CONVERSATIONS[:1], pad=16)[0]
    ev_args = (batch["input_ids"], batch["labels"], batch["frames"], 0.0)
    casts = _Casts(monkeypatch, of=params["llama"]["lm_head"]["q8"])
    loss0, g0 = _port_grads(params, cfg, tb, **kw)
    ev0 = StreamEvaluator(params, cfg)(*ev_args)
    assert casts.widest() == V          # untiled: the whole head each call
    monkeypatch.setattr(quant, "head_tile_cols", lambda v: tile)
    casts.shapes.clear()
    loss1, g1 = _port_grads(params, cfg, tb, **kw)
    assert casts.shapes and casts.widest() == tile < V
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)
    casts.shapes.clear()
    ev1 = StreamEvaluator(params, cfg)(*ev_args)
    np.testing.assert_array_equal(ev1, ev0)
    assert casts.shapes and casts.widest() == tile


# ------------------------------------------------------------ grouped remat
def test_remat_group_equals_per_layer_remat_and_jax(fit, monkeypatch):
    """remat_group=2: loss and gradients torch.equal to per-layer remat
    with dropout on and off; with dropout off within the parity
    tolerances of JAX's loss_fn(remat_group=2); the backward recomputes
    every layer once and each group's layers before its last once more."""
    jcfg, jtok, cfg, tok, jparams, nb, tb = fit
    params = params_from_numpy(jparams, device="cpu")
    calls = []
    layer = llama._layer
    monkeypatch.setattr(llama, "_layer",
                        lambda *a, **k: calls.append(1) or layer(*a, **k))
    L = cfg.llama.num_layers
    for c, seed in ((cfg, 7), (_no_dropout(cfg), None)):
        ref = _port_grads(params, c, tb, dropout_seed=seed, remat_group=1)
        calls.clear()
        got = _port_grads(params, c, tb, dropout_seed=seed, remat_group=2)
        assert len(calls) == L + L // 2 + L
        assert torch.equal(got[0], ref[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    _hold_to_jax(got, jparams, _no_dropout(jcfg), nb, remat=True,
                 remat_group=2)


# ------------------------------------------------------------ sliced MLP
@pytest.mark.parametrize("dropout", [False, True])
def test_mlp_chunk_equals_whole_mlp_and_jax(fit, dropout):
    """mlp_chunk: the loss of the whole MLP, bit for bit, with dropout off
    and on (each slice's masks cut from the whole draw), gradients within
    CHUNK_GRAD_TOL; with dropout off near JAX's sliced loss_fn."""
    jcfg, jtok, cfg, tok, jparams, nb, tb = fit
    if not dropout:
        cfg, jcfg = _no_dropout(cfg), _no_dropout(jcfg)
    params = params_from_numpy(jparams, device="cpu")
    T = tb["input_ids"].shape[1]
    chunk = T // 4
    sliced = cfg.replace(llama=dataclasses.replace(cfg.llama,
                                                   mlp_chunk=chunk))
    seed = 7 if dropout else None
    ref = _port_grads(params, cfg, tb, dropout_seed=seed)
    got = _port_grads(params, sliced, tb, dropout_seed=seed)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **CHUNK_GRAD_TOL)
    if not dropout:
        _hold_to_jax(got, jparams, jcfg.replace(llama=dataclasses.replace(
            jcfg.llama, mlp_chunk=chunk)), nb)


# ------------------------------------------------------------ offload
def test_offload_step_equals_plain(fit):
    """Three offloaded steps (the boundary variant, the CPU's) equal three
    plain steps bit for bit, params, moments and loss, with the moments in
    host copies of their own between steps; the in-step probe is false
    without a card."""
    jcfg, jtok, cfg, tok, jparams, nb, tb = fit
    assert offload.supports_in_step_offload() is False
    assert offload.supports_in_step_offload("cpu") is False
    ocfg = optim.OptimConfig(learning_rate=1e-2, warmup_ratio=0.2,
                             total_steps=10)
    sched = optim.make_schedule(ocfg)
    kw = dict(cfg=cfg, optim_cfg=ocfg, schedule=sched, remat_group=2)
    plain, frozen = step_mod.init_train_state(
        params_from_numpy(jparams, device="cpu"))
    off, _ = step_mod.init_train_state(params_from_numpy(jparams,
                                                         device="cpu"))
    off = offload.offload_state(off)
    step = offload.make_offload_train_step(cfg, ocfg, sched, remat_group=2)
    for _ in range(3):
        held = optim.tree_leaves(off.opt_state.mu)
        plain, mp = step_mod.train_step(plain, frozen, tb, **kw)
        off, mo = step(off, frozen, tb)
        assert torch.equal(mp["loss"], mo["loss"])
        assert not any(a is b for a, b in zip(
            held, optim.tree_leaves(off.opt_state.mu)))
    for a, b in zip(*(optim.tree_leaves(
            {"p": t.trainable, "m": t.opt_state.mu, "v": t.opt_state.nu})
            for t in (plain, off))):
        assert torch.equal(a.detach(), b.detach())
    n = sum(x.numel() * 4 for x in optim.tree_leaves(plain.trainable))
    assert step.moved == {"to_device": 6 * n, "to_host": 6 * n}


def test_trainer_offload_and_remat_group_equal_jax(fit, tmp_path,
                                                  monkeypatch):
    """LiveTrainer with --offload_optimizer --remat_group 2 logs the JAX
    trainer's offloaded run's losses within the trainer test's rtol."""
    # the JAX logger's TensorBoard writer imports TensorFlow (seconds);
    # its losses go to metrics.jsonl either way
    monkeypatch.setitem(sys.modules, "flax.metrics.tensorboard", None)
    jcfg, jtok, cfg, tok, jparams, nb, tb = fit
    jcfg, cfg = _no_dropout(jcfg), _no_dropout(cfg)
    ds = [_sample(tok, c, i) for i, c in enumerate(CONVERSATIONS)]
    jds = [_sample(jtok, c, i) for i, c in enumerate(CONVERSATIONS)]
    extra = ["--max_steps", "3", "--offload_optimizer", "true",
             "--remat_group", "2"]
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxLiveTrainer(params=jparams, cfg=jcfg, tokenizer=jtok,
                   args=_train_args(jax_arguments.parse_args, jout, extra),
                   train_dataset=jds,
                   collate_fn=jax_collator.make_collator(jtok, 16)).train()
    trainer = LiveTrainer(params=params_from_numpy(jparams, device="cpu"),
                          cfg=cfg, tokenizer=tok,
                          args=_train_args(arguments.parse_args, out, extra),
                          train_dataset=ds,
                          collate_fn=collator.make_collator(tok, 16))
    trainer.train()
    want, got = _logged_losses(jout), _logged_losses(out)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert trainer._offload_step.moved["to_device"] > 0
    assert all(x.device.type == "cpu"
               for x in optim.tree_leaves(trainer.state.opt_state.mu))


# ------------------------------------------------------------ mu_dtype
def test_mu_dtype_matches_optax():
    """OptimConfig(mu_dtype="bfloat16") on fp32 trainables: three clip +
    AdamW steps equal optax's adamw(mu_dtype=bfloat16) through the JAX
    make_optimizer, the first moment stored in bf16."""
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(8, 16).astype(np.float32),
              "b": {"c": rng.randn(16).astype(np.float32)}}
    ocfg = dict(learning_rate=1e-2, warmup_ratio=0.2, total_steps=10,
                max_grad_norm=0.5, mu_dtype="bfloat16")
    tx = jax_optim.make_optimizer(jax_optim.OptimConfig(**ocfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    pcfg = optim.OptimConfig(**ocfg)
    p = optim.tree_map(torch.from_numpy, params)
    state = optim.init_adam(p, "bfloat16")
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         params)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        p, state = optim.adamw_update(optim.tree_map(torch.from_numpy, g),
                                      state, p, pcfg,
                                      optim.make_schedule(pcfg))
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    for a, b in zip(optim.tree_leaves(p), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(optim.tree_leaves(state.mu), jax.tree.leaves(adam.mu)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("clip,weight_decay,mu_dtype", [
    (0.5, 0.0, ""), (100.0, 0.1, ""), (0.5, 0.0, "float32")])
def test_bf16_adam_matches_optax(clip, weight_decay, mu_dtype):
    """bf16 trainables (phase 8's dtypes): three clip + AdamW steps
    through the JAX make_optimizer give optax's bits, params and both
    moments, with the clip firing (its norm summed in bf16), with a weight
    decay, and with the first moment stored in fp32."""
    rng = np.random.RandomState(5)
    params = {"a": rng.randn(32, 64).astype(np.float32),
              "b": {"c": rng.randn(64).astype(np.float32)}}
    ocfg = dict(learning_rate=1e-2, warmup_ratio=0.2, total_steps=10,
                max_grad_norm=clip, weight_decay=weight_decay,
                mu_dtype=mu_dtype)
    tx = jax_optim.make_optimizer(jax_optim.OptimConfig(**ocfg))

    def bf16(tree):
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)

    def port(tree):
        return optim.tree_map(lambda x: torch.from_numpy(x).bfloat16(), tree)
    jp = bf16(params)
    jstate = tx.init(jp)
    pcfg = optim.OptimConfig(**ocfg)
    p = port(params)
    state = optim.init_adam(p, mu_dtype)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32),
                         params)
        # op by op, as the port runs: under jit XLA on the CPU may keep a
        # bf16 product in fp32 inside a fused sum (its excess precision)
        updates, jstate = tx.update(bf16(g), jstate, jp)
        jp = jax.tree.map(lambda x, u: (x + u).astype(x.dtype), jp, updates)
        p, state = optim.adamw_update(port(g), state, p, pcfg,
                                      optim.make_schedule(pcfg))
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    for got, want, dt in ((p, jp, "bfloat16"),
                          (state.mu, adam.mu, mu_dtype or "bfloat16"),
                          (state.nu, adam.nu, "bfloat16")):
        for a, b in zip(optim.tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == getattr(torch, dt) and b.dtype == jnp.dtype(dt)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
