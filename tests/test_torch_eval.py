"""The port's offline evaluation against the JAX package's.

The same tiny fp32 weights (carried over from the JAX params by
``params_from_numpy``) and the same samples in both packages:
``StreamEvaluator`` on the plain turn scan, with a threshold and on the
rollforward branch (``frame_diff``, ``fluency`` and ``lm_correctness``
equal, ``lm_ppl`` within LM_PPL_RTOL), the rollforward's ring left as the
prefill wrote it, ``greedy_from_embeds`` and the beam search's ids equal to
JAX ``search`` and ``search_host``, the prefill's kernel route, then
``LiveTrainer.evaluate`` on the three evaluators and ``evaluate_entry`` on
a synthetic COIN root, each against the JAX package's.
"""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

os.environ.setdefault("USE_TF", "0")   # transformers' TF import is slow

from videollm_online_tpu.core.arguments import parse_args as jax_parse_args
from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.data import registry as jax_registry
from videollm_online_tpu.eval import generation as jax_gen
from videollm_online_tpu.eval import stream_evaluate as jax_se
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.models.builder import (
    build_model_and_tokenizer as jax_build)
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes
from videollm_online_tpu.train import trainer as jax_trainer
from videollm_online_tpu.train.trainer import LiveTrainer as JaxTrainer

from videollm_online_tpu_torch.core.arguments import parse_args
from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.data import registry
from videollm_online_tpu_torch.data.collator import collate
from videollm_online_tpu_torch.eval import generation, stream_evaluate
from videollm_online_tpu_torch.eval.stream_evaluate import StreamEvaluator
from videollm_online_tpu_torch.models import live, llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.ops.flash_attention import flash_attention
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
from videollm_online_tpu_torch.train.trainer import LiveTrainer
from videollm_online_tpu_torch.utils.logging import MetricLogger

from _synthetic import common_data_kwargs, make_coin_root
from test_datasets import ego4d_root  # noqa: F401  (the synthetic tree)

# lm_ppl is exp(mean NLL): the same fp32 forward summed in another order
# (XLA's fused reductions against eager torch) moves it by a few ulps
LM_PPL_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb_lora(tree, seed):
    """The LoRA B matrices (zero at init) drawn at random, so the adapter
    changes the forward in both packages alike."""
    rng = np.random.RandomState(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key == "lora_b":
            return (rng.randn(*a.shape) * 0.05).astype(a.dtype)
        return a
    return walk(tree)


@pytest.fixture(scope="module")
def setup():
    jtok = JaxTokenizer(JaxBytes(), jax_tiny_cfg())
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(0),
                                                  jtok.cfg))
    jparams["lora"] = _perturb_lora(jparams["lora"], 1)
    params = params_from_numpy(jparams, device="cpu")
    return jtok, tok, jparams, params


def _stream_batch(tok, cfg, n_frames_turns, seed):
    conv = [{"role": "system", "content": "sys."}]
    for i, nf in enumerate(n_frames_turns):
        conv.append({"role": "stream", "num_frames": nf, "learn": True})
        conv.append({"role": "assistant", "content": f"event {i} happens.",
                     "learn": True})
    frames = np.random.RandomState(seed).randn(
        sum(n_frames_turns), cfg.frame_num_tokens,
        cfg.vision_hidden_size).astype(np.float32)
    return collate([(tok.apply_chat_template(conv), frames,
                     tok.get_learn_ranges(conv), 0, None)], tokenizer=tok)


def _favourite(params, cfg, batch):
    """The model's argmax at the first supervised stream position."""
    logits, _ = live.forward(params, cfg,
                             input_ids=torch.from_numpy(batch["input_ids"]),
                             frames=torch.from_numpy(batch["frames"]))
    ids, labels = batch["input_ids"][0], batch["labels"][0]
    v_pos = np.nonzero((ids == cfg.v_placeholder_id) & (labels != -100))[0]
    return int(logits[0, v_pos[0]].argmax())


# (frames per turn, seed, threshold, pin the interval id to the favourite)
STREAM_SCENARIOS = {"plain": ([3, 4, 2], 0, 0.0, False),
                    "threshold": ([2, 5], 1, 0.5, False),
                    "rollforward": ([2, 2, 2], 0, 0.0, True)}


@pytest.mark.parametrize("scenario", list(STREAM_SCENARIOS))
def test_stream_evaluate_equal_jax(scenario, setup, monkeypatch):
    jtok, tok, jparams, params = setup
    turns, seed, threshold, pin = STREAM_SCENARIOS[scenario]
    jcfg, cfg = jtok.cfg, tok.cfg
    batch = _stream_batch(tok, cfg, turns, seed)
    if pin:
        fav = _favourite(params, cfg, batch)
        assert fav != cfg.eos_token_id
        jcfg = jcfg.replace(frame_token_interval_id=fav)
        cfg = cfg.replace(frame_token_interval_id=fav)
    rolls = []
    roll = StreamEvaluator._rollforward
    monkeypatch.setattr(StreamEvaluator, "_rollforward",
                        lambda self, *a: rolls.append(roll(self, *a))
                        or rolls[-1])
    want = jax_se.StreamEvaluator(jparams, jcfg)(
        batch["input_ids"], batch["labels"], batch["frames"], threshold)
    got = StreamEvaluator(params, cfg)(
        batch["input_ids"], batch["labels"], batch["frames"], threshold)
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=LM_PPL_RTOL)
    assert np.isfinite(got).all()
    assert bool(rolls) == pin, rolls   # the branch ran where it was pinned


def test_rollforward_restores_the_ring(setup):
    """A rollforward over a prefilled ring returns JAX's value, and leaves
    every leaf of the ring as the prefill wrote it (JAX rolls a copy)."""
    jtok, tok, jparams, params = setup
    batch = _stream_batch(tok, tok.cfg, [4, 4], 3)
    ids, labels, frames = (batch["input_ids"], batch["labels"],
                           batch["frames"])
    T = ids.shape[1]
    cap = T + 3 * (tok.cfg.frame_num_tokens + 1)
    jev = jax_se.StreamEvaluator(jparams, jtok.cfg)
    jcache = jax_llama.init_kv_cache(jtok.cfg.llama, 1, cap, jnp.float32)
    *_, jcache = jev._stats(jparams, jnp.asarray(ids), jnp.asarray(labels),
                            jnp.asarray(frames), jcache)
    ev = StreamEvaluator(params, tok.cfg)
    cache = llama.init_kv_cache(tok.cfg.llama, 1, cap, device="cpu")
    with torch.no_grad():
        stream_evaluate._per_token_stats(
            params, tok.cfg, torch.from_numpy(ids), torch.from_numpy(labels),
            torch.from_numpy(frames), ev.interval_id, cache)
    before = (cache.k.clone(), cache.v.clone(), cache.offset.clone(),
              cache.pos_base.clone())
    for trim_to, start, n in ((T - 20, 4, 3), (T // 2, 2, 2)):
        want = jev._rollforward(jcache, trim_to, frames, start, n, 0.3)
        assert ev._rollforward(cache, trim_to, frames, start, n, 0.3) == want
        for a, b in zip((cache.k, cache.v, cache.offset, cache.pos_base),
                        before):
            assert torch.equal(a, b)


def _prompt(tok, cfg, n_frames, seed):
    conv = [{"role": "system", "content": "sys."},
            {"role": "stream", "num_frames": n_frames, "learn": False},
            {"role": "user", "content": "What happens next?"}]
    frames = np.random.RandomState(seed).randn(
        n_frames, cfg.frame_num_tokens,
        cfg.vision_hidden_size).astype(np.float32)
    batch = collate([(tok.apply_chat_template(conv,
                                              add_generation_prompt=True),
                      frames, [], 0, None)], tokenizer=tok)
    return batch["input_ids"], batch["frames"]


@pytest.mark.parametrize("seed,max_new", [(0, 7), (1, 30)])
def test_greedy_from_embeds_equal_jax(seed, max_new, setup):
    jtok, tok, jparams, params = setup
    ids, frames = _prompt(tok, tok.cfg, 3, seed)
    want = jax_gen.greedy_from_embeds(jparams, jtok.cfg, ids, frames,
                                      max_new_tokens=max_new)
    got = generation.greedy_from_embeds(params, tok.cfg, ids, frames,
                                        max_new_tokens=max_new)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] >= 1


# (seed, beams, new tokens, returned sequences, length penalty, the eos id
#  pinned to the prompt's n-th likeliest token or None)
BEAM_CASES = [(0, 5, 9, None, 1.0, None), (1, 3, 24, 2, 0.7, 2),
              (2, 4, 16, 4, 1.0, 1)]


@pytest.mark.parametrize("case", BEAM_CASES, ids=["natural", "eos_lp",
                                                  "eos_first"])
def test_beam_search_equal_jax(case, setup):
    seed, K, max_new, n_ret, lp, eos_rank = case
    jtok, tok, jparams, params = setup
    jcfg, cfg = jtok.cfg, tok.cfg
    ids, frames = _prompt(tok, cfg, 2, seed)
    if eos_rank is not None:
        logp, _ = generation.BeamSearcher(params, cfg, K)._embed_and_prefill(
            ids, frames, None, max_new)
        eos = int(torch.argsort(logp[0], descending=True)[eos_rank])
        jcfg, cfg = jcfg.replace(eos_token_id=eos), cfg.replace(
            eos_token_id=eos)
    kw = dict(max_new_tokens=max_new, num_return_sequences=n_ret,
              length_penalty=lp)
    jsearch = jax_gen.BeamSearcher(jparams, jcfg, K)
    want = jsearch.search(ids, frames, **kw)
    want_host = jsearch.search_host(ids, frames, **kw)
    got = generation.BeamSearcher(params, cfg, K).search(ids, frames, **kw)
    assert len(got) == (n_ret or K)
    for g, w, wh in zip(got, want, want_host):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, wh)
    if eos_rank is not None:
        assert any(int(s[-1]) == cfg.eos_token_id for s in got)
    if lp == 1.0:
        np.testing.assert_array_equal(
            generation.beam_generate(params, cfg, ids, frames, num_beams=K,
                                     max_new_tokens=max_new,
                                     num_return_sequences=n_ret),
            jax_gen.beam_generate(jparams, jcfg, ids, frames, num_beams=K,
                                  max_new_tokens=max_new,
                                  num_return_sequences=n_ret))


def test_prefill_attn_route():
    """The card's flash route (JAX's rule): a ring in the model dtype, T a
    multiple of 128, d 64/128/256; the plain attention otherwise. The
    attention has no layered form, so the decoder hands it one layer."""
    def q(T=256, d=64, cuda=True):
        return types.SimpleNamespace(is_cuda=cuda, shape=(1, 8, T, d))
    route = stream_evaluate._flash_route
    assert route(q(), None) and route(q(128, 128), None)
    assert route(q(384, 256), None)
    assert not route(q(200), None)
    assert not route(q(d=32), None)
    assert not route(q(cuda=False), None)
    assert not route(q(), k_scale=object())
    assert not hasattr(stream_evaluate._prefill_attn, "layered")


@pytest.mark.parametrize("window", [None, 48])
def test_prefill_slice_equals_plain_over_the_ring(window):
    """What the flash route computes (K2f's plain version over the ring's
    first T slots) equals the plain attention over the whole ring, whose
    slots past T hold rows no query may read."""
    g = torch.Generator().manual_seed(0)
    T, C, d = 256, 320, 64
    q = torch.randn(1, 4, T, d, generator=g)
    k = torch.randn(1, 2, C, d, generator=g)
    v = torch.randn(1, 2, C, d, generator=g)
    got = flash_attention(q, k[:, :, :T], v[:, :, :T], 1.0 / d ** 0.5, True,
                          0, window=window)
    want = stream_evaluate._prefill_attn(
        q, k, v, torch.arange(T)[None], None, num_groups=2,
        sliding_window=window)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


# ------------------------------------------------------------ the trainer

def _tiny_args(out, extra=()):
    return ["--live_version", "live1+", "--model_size", "tiny",
            "--bf16", "false", "--vision_hidden_size", "32",
            "--pad_to_multiple", "16", "--output_dir", out, *extra]


# new tokens of the generate evaluators in these tests (the datasets ask
# for 512, which random weights always reach: no EOS)
MAX_NEW = 40


def _short_generation(*datasets):
    for ds in datasets:
        ds.evaluation_kwargs = dict(ds.evaluation_kwargs,
                                    max_new_tokens=MAX_NEW)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory, setup, ego4d_root):  # noqa: F811
    jtok, tok, jparams, params = setup
    coin = make_coin_root(str(tmp_path_factory.mktemp("coin")))
    out = str(tmp_path_factory.mktemp("eval"))
    names = {"ego4d_narration_stream_train": ego4d_root,
             "ego4d_lta_train": ego4d_root, "coin_step_test": coin}
    jdict = {n: jax_registry._REGISTRY[n](
        is_training=False, **common_data_kwargs(jtok, r))
        for n, r in names.items()}
    pdict = {n: registry._REGISTRY[n](
        is_training=False, **common_data_kwargs(tok, r))
        for n, r in names.items()}
    _short_generation(*jdict.values(), *pdict.values())
    # the JAX trainer's TensorBoard writer (through flax, which imports
    # TensorFlow: some 10 s) has no part in the metrics
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer, "MetricLogger", MetricLogger)
        want = JaxTrainer(params=jax.tree.map(jnp.asarray, jparams),
                          cfg=jtok.cfg, tokenizer=jtok,
                          args=jax_parse_args(_tiny_args(out + "/jax")),
                          eval_dataset_dict=jdict)
    got = LiveTrainer(params=params, cfg=tok.cfg, tokenizer=tok,
                      args=parse_args(_tiny_args(out + "/torch")),
                      eval_dataset_dict=pdict)
    return want, got


def _assert_metrics_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key, w in want[name].items():
            if key == "lm_ppl":
                np.testing.assert_allclose(got[name][key], w,
                                           rtol=LM_PPL_RTOL)
            else:
                assert got[name][key] == w, (name, key)


@pytest.mark.parametrize("name,count", [
    # every sample, one of two, one of three
    ("ego4d_narration_stream_train", 1), ("coin_step_test", 2),
    ("ego4d_lta_train", 3)])
def test_trainer_evaluate_equal_jax(name, count, trainers):
    want_trainer, got_trainer = trainers
    want = want_trainer.evaluate(name, process_index=0, process_count=count)
    got = got_trainer.evaluate(name, process_index=0, process_count=count)
    _assert_metrics_equal(got, want)


def test_trainer_evaluate_refuses_a_process_group(trainers, monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        trainers[1].evaluate("coin_step_test")


def test_evaluate_entry_equal_jax(tmp_path, monkeypatch):
    """Both entry points on one tiny HF decoder (``--llm_weights``) and one
    adapter, saved in each package's format (``--resume_from_checkpoint``):
    the same metrics, and each writes eval_results.json."""
    import json
    import transformers
    from videollm_online_tpu.data.coin import base as jax_coin
    from videollm_online_tpu.evaluate_entry import evaluate as jax_evaluate
    from videollm_online_tpu.train.checkpoints import (
        save_adapter as jax_save_adapter)
    from videollm_online_tpu_torch.data.coin import base as coin
    from videollm_online_tpu_torch.evaluate_entry import evaluate
    from videollm_online_tpu_torch.models.builder import PROXY_SIZES
    from videollm_online_tpu_torch.train.checkpoints import save_adapter

    from videollm_online_tpu.data.coin import benchmarks as jax_bench
    from videollm_online_tpu_torch.data.coin import benchmarks

    root = make_coin_root(str(tmp_path / "coin"))
    monkeypatch.setattr(jax_trainer, "MetricLogger", MetricLogger)
    monkeypatch.setattr(jax_coin.COIN, "root", root)
    monkeypatch.setattr(coin.COIN, "root", root)
    for cls in (jax_bench.COINBenchmark, benchmarks.COINBenchmark):
        monkeypatch.setattr(cls, "evaluation_kwargs", dict(
            cls.evaluation_kwargs, max_new_tokens=MAX_NEW))
    c = PROXY_SIZES["tiny"]
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_layers"],
        num_attention_heads=c["num_heads"],
        num_key_value_heads=c["num_kv_heads"], head_dim=c["head_dim"],
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False))
    hf.save_pretrained(str(tmp_path / "hf"), safe_serialization=True)

    common = _tiny_args("", ["--llm_weights", str(tmp_path / "hf"),
                             "--eval_datasets", "coin_step_test"])
    jparams, _, _ = jax_build(jax_parse_args(common))
    adapter = _perturb_lora(jax.device_get(
        {"lora": jparams["lora"], "connector": jparams["connector"]}), 3)
    jax_save_adapter(str(tmp_path / "jax" / "adapter"),
                     jax.tree.map(jnp.asarray, adapter))
    save_adapter(str(tmp_path / "torch" / "adapter"),
                 params_from_numpy(adapter, device="cpu"))

    def run(fn, which, extra=()):
        out = str(tmp_path / which / "out")
        return fn([*extra, *common, "--output_dir", out,
                   "--resume_from_checkpoint", str(tmp_path / which)]), out

    want, jout = run(jax_evaluate, "jax")
    got, out = run(evaluate, "torch", ("--device", "cpu"))
    _assert_metrics_equal(got, want)
    for d in (jout, out):
        with open(os.path.join(d, "eval_results.json")) as f:
            assert json.load(f) == json.loads(json.dumps(got))


def test_train_entry_trains_saves_and_evaluates(tmp_path, monkeypatch):
    """The port's train_entry end to end on a synthetic COIN root (the JAX
    package's tests/test_train_e2e.py run): the loss falls over six steps,
    the adapter is saved where evaluate_entry's --resume_from_checkpoint
    finds it, and the eval dataset's metrics are written. LoRA dropout
    draws other masks than JAX's, so the loss is held to its own trend."""
    import json
    from videollm_online_tpu_torch.data.coin import base as coin
    from videollm_online_tpu_torch.data.coin import benchmarks
    from videollm_online_tpu_torch.train import checkpoints
    from videollm_online_tpu_torch.train_entry import train

    root = make_coin_root(str(tmp_path / "coin"))
    monkeypatch.setattr(coin.COIN, "root", root)
    monkeypatch.setattr(benchmarks.COINBenchmark, "evaluation_kwargs", dict(
        benchmarks.COINBenchmark.evaluation_kwargs, max_new_tokens=MAX_NEW))
    out = str(tmp_path / "run")
    argv = ["--device", "cpu", *_tiny_args(out, [
        "--train_datasets", "coin_step_train",
        "--eval_datasets", "coin_step_test", "--max_steps", "6",
        "--lora_r", "8", "--lora_alpha", "16",
        "--learning_rate", "1e-3", "--logging_steps", "1",
        "--dataloader_num_workers", "0"])]
    trainer = train(argv)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses) == 6 and losses[-1] < losses[0]
    adapter = checkpoints.load_adapter_into(trainer.params,
                                            os.path.join(out, "adapter"))
    assert torch.equal(adapter["connector"]["fc1"]["w"],
                       trainer.params["connector"]["fc1"]["w"])
    with open(os.path.join(out, "eval_results.json")) as f:
        assert "accuracy" in json.load(f)["coin_step_test"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        train(argv + ["--attn_implementation", "sp_ring"])
