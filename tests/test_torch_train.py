"""The port's training slice against the JAX package on the tiny config.

The same numpy-seeded inputs and the same weights (made by the JAX package,
carried over with ``params_from_numpy``) go through both. Everything is
fp32 with LoRA dropout 0 (the JAX package draws its masks from the TPU's
``rbg`` bits, which the port does not reproduce; its own dropout is tested
for its law and for being redrawn the same under remat). Tolerances:
losses rtol 1e-5 and gradients atol 1e-6 / rtol 1e-4 (fp32 sums in another
order); after two optimizer steps the moments atol 1e-6 / rtol 1e-4 and
the parameters atol 5e-5, half a percent of one step of lr 1e-2 (Adam's
mu / sqrt(nu) amplifies that sum-order noise where a gradient's two steps
nearly cancel); the LR schedule rtol 1e-5 (optax computes it in fp32).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from videollm_online_tpu.core import arguments as jax_arguments
from videollm_online_tpu.core.config import LoraConfig as JaxLoraConfig
from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_live
from videollm_online_tpu.data import collator as jax_collator
from videollm_online_tpu.data.loader import DataLoader as JaxDataLoader
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import quant as jax_quant
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxLiveTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxByte
from videollm_online_tpu.train import optim as jax_optim
from videollm_online_tpu.train import step as jax_step
from videollm_online_tpu.train.trainer import LiveTrainer as JaxLiveTrainer

from videollm_online_tpu_torch.core import arguments
from videollm_online_tpu_torch.core.config import LoraConfig
from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.data import collator
from videollm_online_tpu_torch.data.loader import DataLoader
from videollm_online_tpu_torch.models import builder, live, llama, quant
from videollm_online_tpu_torch.models.bridge import (params_from_numpy,
                                                     train_state_from_numpy)
from videollm_online_tpu_torch.ops import flash_attention as fa
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
from videollm_online_tpu_torch.train import checkpoints, optim
from videollm_online_tpu_torch.train import step as step_mod
from videollm_online_tpu_torch.train.trainer import LiveTrainer

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)

CONVERSATIONS = [
    [{"role": "system", "content": "sys."},
     {"role": "stream", "num_frames": 3, "learn": True},
     {"role": "assistant", "content": "hello there", "learn": True},
     {"role": "stream", "num_frames": 2, "learn": True},
     {"role": "assistant", "content": "bye", "learn": True}],
    [{"role": "system", "content": "s."},
     {"role": "user", "content": "what now?"},
     {"role": "stream", "num_frames": 4, "learn": True},
     {"role": "assistant", "content": "a cut", "learn": True}],
    [{"role": "system", "content": "s."},
     {"role": "stream", "num_frames": 2, "learn": False},
     {"role": "user", "content": "go"},
     {"role": "stream", "num_frames": 3, "learn": True},
     {"role": "assistant", "content": "ok!", "learn": True}],
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**overrides):
    kw = dict(lora=None, stream_loss_weight=2.0)
    kw.update(overrides)
    jcfg = jax_tiny_live(**{**kw, "lora": kw["lora"] and JaxLoraConfig(
        **dataclasses.asdict(kw["lora"]))})
    pcfg = tiny_live_config(**kw)
    jtok = JaxLiveTokenizer(JaxByte(), jcfg)
    ptok = LiveTokenizer(ByteTokenizer(), pcfg)
    return jtok.cfg, jtok, ptok.cfg, ptok


@pytest.fixture(scope="module")
def setup():
    """Tiny fp32 config with LoRA (dropout 0), JAX params with non-zero
    LoRA B (so every trainable gets a gradient), and the bridged copy."""
    jcfg, jtok, cfg, tok = _configs(lora=LoraConfig(r=4, alpha=8,
                                                    dropout=0.0))
    jparams = jax_live.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    jparams["lora"] = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(rng.randn(*x.shape), x.dtype),
        jparams["lora"])
    jparams = jax.device_get(jparams)
    return jcfg, jtok, cfg, tok, jparams


def _np(x):
    return x.detach().cpu().float().numpy() if torch.is_tensor(x) else \
        np.asarray(x)


def _sample(tok, conv, seed):
    frames = np.random.RandomState(seed).randn(
        sum(m.get("num_frames", 0) for m in conv), tok.cfg.frame_num_tokens,
        tok.cfg.vision_hidden_size).astype(np.float32)
    return (tok.apply_chat_template(conv), frames, tok.get_learn_ranges(conv),
            seed, None)


def _batch(jtok, tok, convs, pad=16):
    """The JAX collate's numpy batch (held equal to the port's in
    test_collate_matches_jax) and its tensors."""
    jb = jax_collator.collate([_sample(jtok, c, i) for i, c in
                               enumerate(convs)], tokenizer=jtok,
                              pad_to_multiple=pad)
    nb = {k: jb[k] for k in ("input_ids", "labels", "frames")}
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _assert_tree_close(got, want, path="", **tol):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], f"{path}/{k}", **tol)
        return
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               err_msg=path, **(tol or GRAD_TOL))


# ------------------------------------------------------------ copied modules
@pytest.mark.parametrize("argv", [
    [],
    ["--live_version", "live1", "--lora_r", "8", "--bf16", "false",
     "--train_datasets", "a", "b", "--learning_rate", "3e-4"],
    ["--frame_token_pooled", "2", "2", "--quantize_base", "int8",
     "--gradient_accumulation_steps", "2", "--chunked_loss", "true"],
])
def test_parse_args_matches_jax(argv):
    want = jax_arguments.parse_args(argv)
    got = arguments.parse_args(argv)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (dataclasses.asdict(got.to_live_config())
            == dataclasses.asdict(want.to_live_config()))


@pytest.mark.parametrize("pad", [1, 16])
def test_collate_matches_jax(setup, pad):
    _, jtok, _, tok, _ = setup
    want = jax_collator.collate(
        [_sample(jtok, c, i) for i, c in enumerate(CONVERSATIONS)],
        tokenizer=jtok, pad_to_multiple=pad)
    got = collator.make_collator(tok, pad)(
        [_sample(tok, c, i) for i, c in enumerate(CONVERSATIONS)])
    assert set(got) == set(want)
    for key in ("input_ids", "labels", "attention_mask", "frames",
                "sample_idxs"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (got["labels"] != -100).sum() > 0


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_order_matches_jax(workers):
    data = list(range(23))
    kw = dict(batch_size=3, collate_fn=list, shuffle=True, seed=7)
    want = JaxDataLoader(data, **kw)
    got = DataLoader(data, num_workers=workers, **kw)
    for _ in range(2):       # two epochs: the shuffle reseeds per epoch
        assert list(got) == list(want)
    assert len(got) == len(want) == 7


# ------------------------------------------------------------ model pieces
def test_quantized_matmul_backward_matches_jax_and_keeps_codes():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 16).astype(np.float32)
    g = rng.randn(3, 5, 8).astype(np.float32)
    w = jax_quant.quantize_weight(jnp.asarray(rng.randn(16, 8), jnp.float32))
    want = jax.grad(lambda a: jnp.sum(jax_quant.quantized_matmul(a, w)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = quant.quantized_matmul(tx, params_from_numpy(jax.device_get(w),
                                                     device="cpu"))
    assert sorted(str(t.dtype) for t in y.grad_fn.saved_tensors) == [
        "torch.float32", "torch.int8"]     # codes and scale, no cast copy
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ids,n_frames", [
    ([[5, "v", 6, "v", "v", 7]], 3),        # in order
    ([["v", 1, "v"], [2, "v", 3]], 3),      # flattened batch order
    ([[5, "v", "v", "v"]], 2),              # more <v> than frames: clipped
])
def test_joint_embed_matches_jax(setup, ids, n_frames):
    jcfg, _, cfg, _, jparams = setup
    v = cfg.v_placeholder_id
    ids = np.asarray([[v if t == "v" else t for t in row] for row in ids])
    frames = np.random.RandomState(2).randn(
        n_frames, cfg.vision_hidden_size).astype(np.float32)
    want = jax_live.joint_embed(jparams, jcfg, jnp.asarray(ids),
                                jnp.asarray(frames))
    got = live.joint_embed(params_from_numpy(jparams, device="cpu"), cfg,
                           torch.from_numpy(ids), torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


def _flash_impl(q, k, v, q_pos, kv_valid_upto, *, num_groups,
                sliding_window=None, **_):
    """The K2 autograd function in the decoder, on its plain CPU path."""
    return fa.flash_attention(q, k, v, 1.0 / q.shape[3] ** 0.5, True, 0,
                              window=sliding_window)


@pytest.mark.parametrize("remat,base,attn,chunked", [
    (True, "fp32", "plain", False),
    (False, "fp32", "plain", False),
    (True, "int8", "plain", False),
    (True, "fp32", "flash", False),
    (True, "fp32", "plain", True),
])
def test_loss_and_grads_match_jax(setup, remat, base, attn, chunked):
    jcfg, jtok, cfg, tok, jparams = setup
    if base == "int8":
        jparams = dict(jparams, llama=jax.device_get(
            jax_quant.quantize_llama_params(jparams["llama"])))
    nb, tb = _batch(jtok, tok, CONVERSATIONS[:2])
    assert (nb["labels"] == -100).any() and (
        nb["input_ids"] == cfg.v_placeholder_id).any()
    jtrain, jfrozen = jax_optim.split_trainable(jparams)
    kw = dict(remat=remat, chunked_loss=chunked, loss_chunk=32)
    want_loss, want_grads = jax.jit(
        jax.value_and_grad(jax_step.loss_fn), static_argnums=2,
        static_argnames=tuple(kw))(
        jtrain, jfrozen, jcfg, {k: jnp.asarray(v) for k, v in nb.items()},
        **kw)
    state, frozen = step_mod.init_train_state(params_from_numpy(jparams,
                                                                device="cpu"))
    if base == "int8":
        assert frozen["llama"]["layers"]["wq"]["q8"].dtype == torch.int8
    assert not any(t.requires_grad for t in optim.tree_leaves(frozen))
    loss = step_mod.loss_fn(state.trainable, frozen, cfg, tb,
                            attn_impl=_flash_impl if attn == "flash" else None,
                            **kw)
    leaves = optim.tree_leaves(state.trainable)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **LOSS_TOL)
    it = iter(grads)
    _assert_tree_close(optim.tree_map(lambda _: next(it), state.trainable),
                       jax.device_get(want_grads))


def test_chunked_loss_equals_unchunked(setup):
    """The streamed lm_head CE gives the unchunked loss and gradients."""
    _, jtok, cfg, tok, jparams = setup
    _, tb = _batch(jtok, tok, CONVERSATIONS)
    state, frozen = step_mod.init_train_state(params_from_numpy(jparams,
                                                                device="cpu"))
    out = []
    for chunked in (False, True):
        loss = step_mod.loss_fn(state.trainable, frozen, cfg, tb,
                                chunked_loss=chunked, loss_chunk=48)
        out.append((loss, torch.autograd.grad(
            loss, optim.tree_leaves(state.trainable))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_dropout_keep_rate_and_scaling():
    """Inverted dropout: keep rate 1 - p (here within 0.005 of it, over
    10 standard deviations at 1e6 draws), kept values x / (1 - p) exactly,
    the same mask from the same seed and another from another seed."""
    p = 0.25
    x = torch.ones(1000, 1000)
    y = llama.dropout(x, p, seed=llama.fold_seed(3, 0, 1))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.005
    assert bool((y[kept] == torch.tensor(1 / (1 - p))).all())
    assert torch.equal(y, llama.dropout(x, p, llama.fold_seed(3, 0, 1)))
    assert not torch.equal(y, llama.dropout(x, p, llama.fold_seed(3, 0, 2)))
    assert llama.fold_seed(3, 0, 1) != llama.fold_seed(3, 1, 0)


def test_dropout_masks_are_redrawn_the_same_under_remat(setup):
    """With dropout on, the remat recompute draws the forward's masks: loss
    and gradients equal the run without remat, and differ from the run
    without dropout."""
    jcfg, jtok, cfg, tok, jparams = setup
    cfg = cfg.replace(lora=LoraConfig(r=4, alpha=8, dropout=0.3))
    _, tb = _batch(jtok, tok, CONVERSATIONS[:1])
    state, frozen = step_mod.init_train_state(params_from_numpy(jparams,
                                                                device="cpu"))
    runs = []
    for remat, seed in ((True, 11), (False, 11), (True, None)):
        loss = step_mod.loss_fn(state.trainable, frozen, cfg, tb,
                                remat=remat, dropout_seed=seed)
        runs.append((loss, torch.autograd.grad(
            loss, optim.tree_leaves(state.trainable))))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(runs[0][0].detach()) != float(runs[2][0].detach())


# ------------------------------------------------------------ optimizer steps
def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.mark.parametrize("accum", [1, 2])
def test_two_train_steps_match_jax(setup, accum):
    """From the same bridged state: step 0 takes learning rate 0 (optax's
    warmup-cosine at the un-incremented count) while the moments move, the
    clip triggers, and both packages end step 1 with the same parameters,
    moments and count."""
    jcfg, jtok, cfg, tok, jparams = setup
    ocfg = dict(learning_rate=1e-2, warmup_ratio=0.2, total_steps=10,
                max_grad_norm=0.5)
    tx = jax_optim.make_optimizer(jax_optim.OptimConfig(**ocfg))
    jstate, jfrozen = jax_step.init_train_state(jparams, tx)
    adam = jax.device_get(_adam_state(jstate.opt_state))
    state = train_state_from_numpy(int(jstate.step),
                                   jax.device_get(jstate.trainable), adam.mu,
                                   adam.nu, int(adam.count), device="cpu")
    frozen = params_from_numpy(jax.device_get(jfrozen), device="cpu")
    start = optim.tree_map(lambda x: x.detach().clone(), state.trainable)
    if accum == 1:
        nb, tb = _batch(jtok, tok, CONVERSATIONS[:2], pad=64)
    else:
        # two microbatches on a leading axis, padded as LiveTrainer pads
        parts = [_batch(jtok, tok, [c], pad=16)[0] for c in CONVERSATIONS[:2]]
        T = max(p["input_ids"].shape[1] for p in parts)
        F = max(p["frames"].shape[0] for p in parts)
        nb = {"input_ids": np.full((2, 1, T), tok.pad_token_id, np.int64),
              "labels": np.full((2, 1, T), -100, np.int64),
              "frames": np.zeros((2, F) + parts[0]["frames"].shape[1:],
                                 np.float32)}
        for a, p in enumerate(parts):
            for k, v in p.items():
                nb[k][(a,) + tuple(slice(0, n) for n in v.shape)] = v
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    pocfg = optim.OptimConfig(**ocfg)
    jax_train_step = jax_step.make_jitted_train_step(jcfg, tx,
                                                     accum_steps=accum)
    for i in range(2):
        jstate, jm = jax_train_step(jstate, jfrozen, jbatch)
        state, m = step_mod.train_step(state, frozen, tb, cfg=cfg,
                                       optim_cfg=pocfg,
                                       schedule=optim.make_schedule(pocfg),
                                       accum_steps=accum)
        assert m["step"] == int(jm["step"]) == i
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(m["grad_norm"]) > ocfg["max_grad_norm"]   # clipped
        if i == 0:
            for a, b in zip(optim.tree_leaves(state.trainable),
                            optim.tree_leaves(start)):
                assert torch.equal(a.detach(), b)            # lr 0 at step 0
    adam = jax.device_get(_adam_state(jstate.opt_state))
    assert state.step == int(jstate.step) == 2
    assert state.opt_state.count == int(adam.count) == 2
    _assert_tree_close(state.trainable, jax.device_get(jstate.trainable),
                       atol=5e-5, rtol=0)
    _assert_tree_close(state.opt_state.mu, adam.mu)
    _assert_tree_close(state.opt_state.nu, adam.nu, atol=1e-9, rtol=1e-4)
    assert not any(torch.equal(a.detach(), b) for a, b in zip(
        optim.tree_leaves(state.trainable), optim.tree_leaves(start))
        if b.abs().sum() > 0)


def test_schedule_matches_optax():
    for ocfg in (dict(total_steps=100, warmup_ratio=0.05),
                 dict(total_steps=7, warmup_ratio=0.5, schedule="constant")):
        want = jax_optim.make_schedule(jax_optim.OptimConfig(**ocfg))
        got = optim.make_schedule(optim.OptimConfig(**ocfg))
        for count in range(0, ocfg["total_steps"] + 3):
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12)


# ------------------------------------------------------------ checkpoints
def test_adapter_and_train_state_round_trip(setup, tmp_path):
    _, jtok, cfg, tok, jparams = setup
    params = params_from_numpy(jparams, device="cpu")
    bumped = dict(params, connector=optim.tree_map(lambda x: x + 1.0,
                                                   params["connector"]))
    checkpoints.save_adapter(str(tmp_path / "a"), bumped)
    restored = checkpoints.load_adapter_into(params, str(tmp_path / "a"))
    _assert_tree_close(restored["connector"],
                       optim.tree_map(_np, bumped["connector"]), atol=0,
                       rtol=0)
    assert restored["llama"] is params["llama"]

    state, frozen = step_mod.init_train_state(params)
    _, tb = _batch(jtok, tok, CONVERSATIONS[:1])
    pocfg = optim.OptimConfig(total_steps=10)
    state, _ = step_mod.train_step(state, frozen, tb, cfg=cfg,
                                   optim_cfg=pocfg,
                                   schedule=optim.make_schedule(pocfg))
    checkpoints.save_train_state(str(tmp_path / "s"), state)
    fresh, _ = step_mod.init_train_state(params)
    back = checkpoints.restore_train_state(str(tmp_path / "s"), fresh)
    assert back.step == state.step == 1 and back.opt_state.count == 1
    for a, b in ((back.trainable, state.trainable),
                 (back.opt_state.mu, state.opt_state.mu),
                 (back.opt_state.nu, state.opt_state.nu)):
        for x, y in zip(optim.tree_leaves(a), optim.tree_leaves(b)):
            assert torch.equal(x.detach(), y.detach())
    assert all(t.requires_grad for t in optim.tree_leaves(back.trainable))
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoints.load_adapter_into(
            dict(params, connector={"fc1": params["connector"]["fc1"]}),
            str(tmp_path / "a"))


# ------------------------------------------------------------ the trainer
def _train_args(parse, out, extra=()):
    return parse(["--live_version", "live1+", "--max_steps", "4",
                  "--gradient_accumulation_steps", "1",
                  "--learning_rate", "1e-2", "--logging_steps", "1",
                  "--dataloader_num_workers", "0", "--pad_to_multiple", "16",
                  "--output_dir", out, *extra])


def _logged_losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def test_live_trainer_loss_trace_matches_jax(setup, tmp_path):
    """Four steps over an in-memory live1+ dataset through each package's
    collator and loader: the logged losses are equal, and the adapter
    saves."""
    jcfg, jtok, cfg, tok, jparams = setup
    convs = CONVERSATIONS * 2
    jds = [_sample(jtok, c, i) for i, c in enumerate(convs)]
    ds = [_sample(tok, c, i) for i, c in enumerate(convs)]
    assert [s[0] for s in jds] == [s[0] for s in ds]
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxLiveTrainer(params=jparams, cfg=jcfg, tokenizer=jtok,
                   args=_train_args(jax_arguments.parse_args, jout),
                   train_dataset=jds,
                   collate_fn=jax_collator.make_collator(jtok, 16)).train()
    trainer = LiveTrainer(params=params_from_numpy(jparams, device="cpu"),
                          cfg=cfg, tokenizer=tok,
                          args=_train_args(arguments.parse_args, out),
                          train_dataset=ds,
                          collate_fn=collator.make_collator(tok, 16))
    trainer.train()
    want, got = _logged_losses(jout), _logged_losses(out)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    trainer.save_model()
    assert os.path.exists(os.path.join(out, "adapter", "adapter.pt"))


def test_trainer_and_builder_refuse_what_later_slices_bring(setup, tmp_path):
    _, _, cfg, tok, jparams = setup
    params = params_from_numpy(jparams, device="cpu")
    base = ["--output_dir", str(tmp_path)]
    # the memory-fit slice came (tests/test_torch_fit.py): offload and
    # grouped remat construct, the moments go to host memory
    for extra in (["--offload_optimizer", "true"], ["--remat_group", "2"]):
        trainer = LiveTrainer(params=params, cfg=cfg, tokenizer=tok,
                              args=arguments.parse_args(base + extra))
        assert (trainer._offload_step is not None) == (
            extra[0] == "--offload_optimizer")
        assert all(x.device.type == "cpu" for x in
                   optim.tree_leaves(trainer.state.opt_state.mu))
    # the parallel slice came (tests/test_torch_trainer_mesh.py): a model
    # axis needs as many processes, and sequence parallelism a model axis
    with pytest.raises(AssertionError, match="not divisible by model=2"):
        LiveTrainer(params=params, cfg=cfg, tokenizer=tok,
                    args=arguments.parse_args(base + ["--mesh_model_axis",
                                                      "2"]))
    args = arguments.parse_args(base)
    with pytest.raises(AssertionError, match="mesh_model_axis > 1"):
        LiveTrainer(params=params, cfg=cfg, tokenizer=tok, args=args,
                    attn_impl="sp_ring")
    # evaluation came with the eval slice (tests/test_torch_eval.py): with
    # no eval datasets there is nothing to report; the sequence-parallel
    # names pass through for the trainer to bind
    assert LiveTrainer(params=params, cfg=cfg, tokenizer=tok,
                       args=args).evaluate() == {}
    from videollm_online_tpu_torch.ops.auto import resolve_attn_impl
    for name in ("sp_ring", "sp_ulysses"):
        assert resolve_attn_impl(name) == name
    _, _, built = builder.build_model_and_tokenizer(
        arguments.parse_args(base + ["--model_size", "tiny",
                                     "--mlp_chunk", "64"]), device="cpu")
    assert built.llama.mlp_chunk == 64
    # llm_weights is no longer refused: it reads safetensors through
    # models/convert.py (tests/test_torch_convert.py), and a missing path
    # says so
    with pytest.raises(FileNotFoundError, match="safetensors"):
        builder.build_model_and_tokenizer(
            arguments.parse_args(base + ["--llm_weights",
                                         str(tmp_path / "none")]),
            device="cpu")


@pytest.mark.parametrize("qbase", ["", "int8"])
def test_builder_matches_jax_layout(tmp_path, qbase):
    """Proxy size, fp32, LoRA, optional int8 base and adapter resume: the
    same tree, shapes and dtypes as the JAX package's builder (the random
    draws differ); an int8 base quantizes to the JAX package's codes."""
    from videollm_online_tpu.models.builder import (
        build_model_and_tokenizer as jax_build)
    argv = ["--model_size", "tiny", "--bf16", "false",
            "--vision_hidden_size", "32", "--output_dir", str(tmp_path)]
    if qbase:
        argv += ["--quantize_base", qbase]
    jp, jtok, jcfg = jax_build(jax_arguments.parse_args(argv))
    params, tok, cfg = builder.build_model_and_tokenizer(
        arguments.parse_args(argv), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp = jax.device_get(jp)

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), path

    walk(params, jp)
    if qbase:
        unq, _, _ = builder.build_model_and_tokenizer(
            arguments.parse_args(argv[:-2]), device="cpu")
        jq = jax.device_get(jax_quant.quantize_llama_params(
            jax.tree.map(lambda x: jnp.asarray(_np(x)), unq["llama"])))
        np.testing.assert_array_equal(
            _np(params["llama"]["layers"]["w_up"]["q8"]),
            jq["layers"]["w_up"]["q8"])
    checkpoints.save_adapter(str(tmp_path / "ck" / "adapter"), params)
    resumed, _, _ = builder.build_model_and_tokenizer(
        arguments.parse_args(argv + ["--resume_from_checkpoint",
                                     str(tmp_path / "ck")]),
        seed=1, device="cpu")
    for a, b in zip(optim.tree_leaves(resumed["lora"]),
                    optim.tree_leaves(params["lora"])):
        assert torch.equal(a, b)
