"""Serving a converted decoder: the port's weight converter and
``serve/cli.py --checkpoint`` against the JAX package's.

A tiny HF Llama at the cli's ``--model_size tiny`` widths, built at random
by ``transformers`` (nothing is downloaded), goes through both converters
(``tools/convert_weights.py`` and ``python -m
videollm_online_tpu_torch.tools.convert_weights``): the trees are equal bit
for bit, plain and int8. Then both clis serve the decoder, as a whole model
``{llama, connector}``, as a bare decoder (which gets a connector from
``--seed``; the test hands the port the JAX package's draw, since the two
generators differ) and under ``--quantize int8``: the dialogues are equal
byte for byte. Then ``save_params`` / ``restore_params`` and the Mistral and
Qwen2 presets.
"""

import dataclasses
import json
import os
import runpy
import sys

import numpy as np
import pytest

import jax
import torch

os.environ.setdefault("USE_TF", "0")   # transformers' TF import is slow
import transformers  # noqa: E402

from videollm_online_tpu.core import config as jax_config  # noqa: E402
from videollm_online_tpu.models import convert as jax_convert  # noqa: E402
from videollm_online_tpu.models import live as jax_live  # noqa: E402
from videollm_online_tpu.serve import cli as jax_cli  # noqa: E402
from videollm_online_tpu.train import checkpoints as jax_ckpt  # noqa: E402

from videollm_online_tpu_torch.core import config  # noqa: E402
from videollm_online_tpu_torch.models.bridge import (  # noqa: E402
    params_from_numpy)
from videollm_online_tpu_torch.models.builder import PROXY_SIZES  # noqa: E402
from videollm_online_tpu_torch.serve import cli  # noqa: E402
from videollm_online_tpu_torch.tools import convert_weights  # noqa: E402
from videollm_online_tpu_torch.train import checkpoints  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = PROXY_SIZES["tiny"]


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
def hf_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hf"))
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=TINY["vocab_size"], hidden_size=TINY["hidden_size"],
        intermediate_size=TINY["intermediate_size"],
        num_hidden_layers=TINY["num_layers"],
        num_attention_heads=TINY["num_heads"],
        num_key_value_heads=TINY["num_kv_heads"], head_dim=TINY["head_dim"],
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False))
    model.save_pretrained(d, safe_serialization=True)
    return d


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            return tree.view(torch.uint16).numpy()
        return tree.numpy()
    a = np.asarray(tree)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("flags", [[], ["--int8"]], ids=["bf16", "int8"])
def test_converters_write_equal_trees(flags, hf_dir, tmp_path, monkeypatch):
    jdst, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", [
        "convert_weights.py", "--src", hf_dir, "--dst", jdst, "--family",
        "llama", "--size", "tiny", *flags])
    runpy.run_path(os.path.join(REPO, "tools", "convert_weights.py"),
                   run_name="__main__")
    convert_weights.main(["--src", hf_dir, "--dst", dst, "--size", "tiny",
                          "--device", "cpu", *flags])
    got = checkpoints.restore_params(dst, device="cpu")
    _assert_trees_equal(_numpy(got), _numpy(jax_ckpt.restore_params(jdst)))
    if flags:
        assert got["layers"]["w_gate"]["q8"].dtype == torch.int8


def _cli_cfg():
    """The config both clis build for ``--model_size tiny --dtype
    float32`` (before the tokenizer's ids, which the connector ignores)."""
    return jax_config.live1_plus_config(
        llama=jax_config.LlamaConfig(**TINY, dtype="float32"), lora=None)


@pytest.fixture(scope="module")
def served(hf_dir, tmp_path_factory):
    """The decoder converted to fp32 by each package (the JAX converter's
    functions, with the fp32 config; the port's command line with
    ``--dtype float32``), as a bare decoder and as a whole model with the
    JAX package's connector, in each package's format."""
    d = tmp_path_factory.mktemp("served")
    sd = jax_convert.load_safetensors_state_dict(hf_dir)
    jllama = jax_convert.llama_params_from_state_dict(sd, _cli_cfg().llama)
    connector = jax_live.init_connector(jax.random.PRNGKey(7), _cli_cfg())
    jax_ckpt.save_params(str(d / "jax_bare"), jllama)
    jax_ckpt.save_params(str(d / "jax_full"),
                         {"llama": jllama, "connector": connector})
    llama = convert_weights.main(["--src", hf_dir, "--dst", str(d / "bare"),
                                  "--size", "tiny", "--dtype", "float32",
                                  "--device", "cpu"])
    checkpoints.save_params(str(d / "full"), {
        "llama": llama, "connector": params_from_numpy(
            jax.device_get(connector), device="cpu")})
    feats = np.random.RandomState(0).randn(12, 10, 1024).astype(np.float32)
    np.save(d / "feats.npy", feats)
    return d


def _dialogue(main, d, ckpt, name, extra=()):
    out = str(d / f"{name}.json")
    main(["--video", str(d / "feats.npy"), "--checkpoint", str(d / ckpt),
          "--model_size", "tiny", "--dtype", "float32", "--num_ticks", "1",
          "--output", out, *extra])
    with open(out) as f:
        return [(m["role"], m["content"]) for m in json.load(f)["messages"]]


@pytest.mark.parametrize("kind", ["full", "bare", "int8"])
def test_cli_serves_converted_decoder_as_jax(kind, served, monkeypatch):
    extra = ["--quantize", "int8"] if kind == "int8" else []
    tree = "bare" if kind == "bare" else "full"
    if kind == "bare":
        # the connector the JAX cli draws from --seed 0, in the port's hands
        want_connector = params_from_numpy(jax.device_get(
            jax_live.init_connector(jax.random.PRNGKey(0), _cli_cfg())),
            device="cpu")
        monkeypatch.setattr(cli.live, "init_connector",
                            lambda gen, cfg, device=None: want_connector)
    want = _dialogue(jax_cli.main, served, f"jax_{tree}", f"jax_{kind}",
                     extra)
    got = _dialogue(cli.main, served, tree, kind, ["--device", "cpu", *extra])
    assert got == want
    assert got[0][0] == "user"
    assert got[0][1].endswith("Please narrate the video in real time.")
    assert any(role == "assistant" for role, _ in got)


def test_cli_tells_checkpoints_apart(served):
    """A whole model is served as saved (in --dtype), a bare decoder gets
    a connector, and a tree is quantized under --quantize."""
    args = cli.parse_args(["--video", "x.npy", "--checkpoint",
                           str(served / "full"), "--device", "cpu",
                           "--dtype", "float32"])
    params, _, cfg, _ = cli.build_model(args)
    saved = checkpoints.restore_params(str(served / "full"), device="cpu")
    assert torch.equal(params["connector"]["fc1"]["w"],
                       saved["connector"]["fc1"]["w"])
    assert cfg.lora is None and "lora" not in params
    args.checkpoint, args.quantize = str(served / "bare"), "int8"
    params, _, _, _ = cli.build_model(args)
    assert params["connector"]["fc1"]["w"].shape == (1024, TINY["hidden_size"])
    assert params["llama"]["layers"]["wq"]["q8"].dtype == torch.int8
    args.quantize, args.dtype = "", "bfloat16"
    params, _, _, _ = cli.build_model(args)
    assert params["llama"]["embed"].dtype == torch.bfloat16


def test_save_restore_params_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, 4, generator=g).to(torch.bfloat16),
            "b": {"q8": torch.randint(-127, 128, (5, 2), dtype=torch.int8,
                                      generator=g),
                  "scale": torch.rand(2, generator=g)}}
    checkpoints.save_params(str(tmp_path), tree)
    got = checkpoints.restore_params(str(tmp_path), device="cpu")
    _assert_trees_equal(_numpy(got), _numpy(tree))


@pytest.mark.parametrize("preset", ["mistral_7b_config", "qwen2_7b_config"])
def test_presets_equal_jax(preset):
    assert (dataclasses.asdict(getattr(config, preset)())
            == dataclasses.asdict(getattr(jax_config, preset)()))
    assert (dataclasses.asdict(getattr(config, preset)(num_layers=2))
            == dataclasses.asdict(getattr(jax_config, preset)(num_layers=2)))
