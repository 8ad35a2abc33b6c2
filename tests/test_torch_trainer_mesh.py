"""Sharded training and evaluation across processes, on the CPU.

* tests/test_sharding.py's computation: the tiny decoder with LoRA cut
  ``fsdp_tp`` over a (data 2, model 2) mesh of four ``gloo`` ranks
  (``tests/_torch_dist.py``), the batch cut by ``shard_batch``: the
  forward's loss and two optimizer steps' losses, grad norms and
  trainable leaves against the JAX package's single-device step on the
  same weights (LoRA dropout 0 on both: the two packages draw other
  masks). Tolerances: the loss rtol 1e-5 and the grad norm 1e-4 (the JAX
  test's own); the leaves 5e-6 absolute, half a percent of one step of
  lr 1e-3 (fp32 sums in another order move an Adam update most where a
  gradient element nearly cancels, as in tests/test_torch_train.py).
* The same mesh with LoRA dropout 0.1, frames in the batch and the
  chunked loss, against the port's own single-rank step: a shard draws
  its block of the whole tensor's dropout masks and its frames from the
  global ``<v>`` count, so the loss agrees within 1e-5 relative; again
  with Ulysses over the model axis on weights cut over data only, as the
  trainer cuts them under a sequence-parallel attention.
* ``train_entry`` with ``--mesh_model_axis 2`` (tensor parallel) and with
  each ``--attn_implementation sp_*`` (sequence parallel) on two ranks:
  the loss trace within JAX's 5e-4 (tests/test_trainer_mesh.py:120-123)
  of the single-process run; each run's end-of-train evaluation (tensor
  parallel on the mesh, each rank on its own samples outside it under
  sp_*) and ``evaluate_entry`` over two processes (samples striped,
  predictions gathered) give the single-process metrics.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from videollm_online_tpu.core.config import (LiveConfig as JaxLiveConfig,
                                             LlamaConfig as JaxLlamaConfig,
                                             LoraConfig as JaxLoraConfig,
                                             tiny_vision_config as jax_vision)
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes
from videollm_online_tpu.train import optim as jax_optim
from videollm_online_tpu.train import step as jax_step

import _torch_parallel_workers as workers
from _synthetic import make_coin_root
from _torch_dist import start_worlds

LLAMA = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
             dtype="float32")
MAX_NEW = 40
PARAM_ATOL = 5e-6
TRAIN = ["--live_version", "live1+", "--model_size", "tiny", "--bf16",
         "false", "--vision_hidden_size", "32", "--pad_to_multiple", "16"]
STEPS = ["--train_datasets", "coin_step_train", "--max_steps", "4",
         "--gradient_accumulation_steps", "1",
         "--per_device_train_batch_size", "4", "--learning_rate", "1e-3",
         "--logging_steps", "1", "--dataloader_num_workers", "0"]
EVAL = ["--eval_datasets", "coin_step_test"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_setup(dropout):
    cfg = JaxLiveConfig(llama=JaxLlamaConfig(**LLAMA), vision=jax_vision(),
                        lora=JaxLoraConfig(r=4, alpha=8, dropout=dropout),
                        vision_hidden_size=32, max_num_frames=64)
    cfg = JaxTokenizer(JaxBytes(), cfg).cfg
    params = jax.device_get(jax_live.init_params(jax.random.PRNGKey(0),
                                                 cfg))
    rng = np.random.RandomState(0)
    B, T = 4, 32
    ids = rng.randint(0, cfg.llama.vocab_size, (B, T))
    labels = np.where(rng.rand(B, T) < 0.5, ids, -100)
    batch = {"input_ids": ids.astype(np.int64),
             "labels": labels.astype(np.int64)}
    return cfg, params, batch


def _with_frames(cfg, batch):
    """Some ids turned into ``<v>`` and the frames they take."""
    rng = np.random.RandomState(1)
    ids = batch["input_ids"].copy()
    ids[rng.rand(*ids.shape) < 0.2] = cfg.v_placeholder_id
    n = int((ids == cfg.v_placeholder_id).sum())
    frames = rng.randn(n // cfg.frame_num_tokens + 1, cfg.frame_num_tokens,
                       cfg.vision_hidden_size).astype(np.float32)
    return dict(batch, input_ids=ids, frames=frames)


def _jax_reference(cfg, params, batch):
    """The JAX single-device loss, two steps' metrics and leaves."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, loss, _ = jax_live.forward(params, cfg, input_ids=jb["input_ids"],
                                  labels=jb["labels"])
    tx = jax_optim.make_optimizer(jax_optim.OptimConfig(
        total_steps=10, learning_rate=1e-3))
    state, frozen = jax_step.init_train_state(
        jax.tree.map(jnp.asarray, params), tx)
    fn = jax_step.make_jitted_train_step(cfg, tx)
    metrics = []
    for _ in range(2):
        state, m = fn(state, frozen, dict(jb))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    leaves = {"/".join(str(k.key) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jax.device_get(state.trainable))[0]}
    return float(loss), metrics, leaves


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's results, and the references computed while they
    run: the JAX package's step, the port's single-rank step and its
    single-process entry runs."""
    tmp = tmp_path_factory.mktemp("mesh")
    coin_root = make_coin_root(str(tmp / "coin"))
    cfg, params, batch = _jax_setup(0.0)
    cfg_kw = {"llama": LLAMA, "lora": dict(r=4, alpha=8, dropout=0.0)}
    drop_cfg_kw = {"llama": LLAMA, "lora": dict(r=4, alpha=8, dropout=0.1)}
    rich = _with_frames(cfg, batch)
    rich_kw = {"chunked_loss": True, "loss_chunk": 16}
    wait = start_worlds([
        (workers.many, 4, ([
            ("sharded_step", (2, params, batch, cfg_kw, "fsdp_tp")),
            ("sharded_step", (2, params, rich, drop_cfg_kw, "fsdp_tp",
                              rich_kw)),
            ("sharded_step", (2, params, rich, drop_cfg_kw, "fsdp_tp",
                              rich_kw, "ulysses"))],)),
        (workers.entry_runs, 2, (coin_root, str(tmp / "two"), TRAIN, [
            ("mesh", "train", STEPS + EVAL + ["--mesh_model_axis", "2"]),
            ("sp_ring", "train", STEPS + EVAL + [
                "--mesh_model_axis", "2", "--attn_implementation",
                "sp_ring"]),
            ("sp_ulysses", "train", STEPS + EVAL + [
                "--mesh_model_axis", "2", "--attn_implementation",
                "sp_ulysses"]),
            ("eval", "evaluate", EVAL)], MAX_NEW)),
    ], tmp / "worlds")
    want = _jax_reference(cfg, params, batch)
    single_rich = workers.sharded_step(0, 1, 1, params, rich, drop_cfg_kw,
                                       "fsdp_tp", rich_kw)
    single = workers.entry_runs(0, 1, coin_root, str(tmp / "one"), TRAIN, [
        ("train", "train", STEPS + EVAL), ("eval", "evaluate", EVAL)],
        MAX_NEW)
    (steps, entries) = wait()
    return want, single_rich, single, steps, entries


def test_sharded_loss_and_steps_equal_jax_single_device(runs):
    want, _, _, steps, _ = runs
    w_loss, w_metrics, w_leaves = want
    for rank, (plain, _, _) in enumerate(steps):
        loss, metrics, leaves = plain
        np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
        for (l, g), (wl, wg) in zip(metrics, w_metrics):
            np.testing.assert_allclose(l, wl, rtol=1e-5)
            np.testing.assert_allclose(g, wg, rtol=1e-4)
        assert sorted(leaves) == sorted(w_leaves)
        for k in leaves:
            np.testing.assert_allclose(leaves[k], w_leaves[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{rank} {k}")


@pytest.mark.parametrize("which", ["fsdp_tp", "fsdp_tp + sp_ulysses"])
def test_sharded_step_with_dropout_frames_and_chunks_equals_single(runs,
                                                                   which):
    """The second with Ulysses over the model axis on weights whole along
    it (cut over data only), the batch over data."""
    _, (s_loss, s_metrics, s_leaves), _, steps, _ = runs
    for per_rank in steps:
        loss, metrics, leaves = per_rank[1 if which == "fsdp_tp" else 2]
        np.testing.assert_allclose(loss, s_loss, rtol=1e-5)
        for (l, g), (sl, sg) in zip(metrics, s_metrics):
            np.testing.assert_allclose(l, sl, rtol=1e-5)
            np.testing.assert_allclose(g, sg, rtol=1e-4)
        for k in leaves:
            np.testing.assert_allclose(leaves[k], s_leaves[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("name,axis", [("mesh", None),
                                       ("sp_ring", "model"),
                                       ("sp_ulysses", "model")])
def test_trainer_loss_trace_on_two_ranks_matches_single(runs, name, axis):
    single, entries = runs[2], runs[4]
    want = single["train"]["losses"]
    got = entries[0][name]["losses"]
    assert len(want) == len(got) == 4
    for a, b in zip(want, got):
        assert abs(a - b) <= 5e-4 * max(abs(a), 1.0), (want, got)
    for rank in range(2):
        assert entries[rank][name]["mesh"].startswith(
            "Mesh(data=1, model=2")
        assert entries[rank][name]["attn"] == axis


def test_evaluate_over_two_processes_equals_single(runs):
    single, entries = runs[2], runs[4]
    want = single["eval"]["metrics"]
    assert want["coin_step_test"]
    for rank in range(2):
        assert entries[rank]["eval"]["metrics"] == want
    assert entries[0]["eval"]["eval"] == single["eval"]["eval"]
    # the evaluation at the end of each two-rank training run: tensor
    # parallel on the mesh, each rank's samples outside it under sp_*
    for name in ("mesh", "sp_ring", "sp_ulysses"):
        assert entries[0][name]["eval"] == single["train"]["eval"], name

