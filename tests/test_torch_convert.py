"""The port's weight conversion against HF and the JAX package.

Tiny HF models built at random by ``transformers`` (nothing is downloaded):
Llama written as one safetensors file and as a sharded directory, Mistral
(``sliding_window``) and Qwen2 (``attention_bias``). The port's
``llama_params_from_state_dict`` tree runs the port's forward, whose
logits are held against HF's and against the JAX package's forward on the
JAX converter's tree (fp32, the JAX tests' bounds against HF). Then the
builder's ``llm_weights`` path and ``build_vision_params`` on a SigLIP
checkpoint.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

os.environ.setdefault("USE_TF", "0")   # transformers' TF import is slow
import transformers  # noqa: E402
from safetensors.torch import save_file  # noqa: E402

from videollm_online_tpu.core.config import LlamaConfig as JaxLlamaConfig
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.models.convert import (
    llama_params_from_state_dict as jax_convert)

from videollm_online_tpu_torch.core import arguments
from videollm_online_tpu_torch.core.config import LlamaConfig, VisionConfig
from videollm_online_tpu_torch.models import builder, llama, quant, siglip
from videollm_online_tpu_torch.models.builder import PROXY_SIZES
from videollm_online_tpu_torch.models.convert import (
    llama_params_from_state_dict, load_safetensors_state_dict,
    siglip_params_from_state_dict)

HF_TOL = dict(atol=3e-4, rtol=3e-3)     # test_mistral/qwen2_parity.py's
JAX_TOL = dict(atol=1e-5, rtol=1e-4)    # the same fp32 forward

FAMILIES = {
    "llama": dict(rope_theta=500000.0, rms_norm_eps=1e-5),
    "mistral": dict(rope_theta=10000.0, rms_norm_eps=1e-5, sliding_window=8),
    "qwen2": dict(rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family):
    return dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                dtype="float32", **FAMILIES[family])


def _hf(family, c):
    kw = dict(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
              intermediate_size=c["intermediate_size"],
              num_hidden_layers=c["num_layers"],
              num_attention_heads=c["num_heads"],
              num_key_value_heads=c["num_kv_heads"],
              rope_theta=c["rope_theta"], rms_norm_eps=c["rms_norm_eps"],
              tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    if family == "llama":
        return transformers.LlamaForCausalLM(transformers.LlamaConfig(
            head_dim=c["head_dim"], attention_bias=False, mlp_bias=False,
            **kw)).eval()
    if family == "mistral":
        return transformers.MistralForCausalLM(transformers.MistralConfig(
            head_dim=c["head_dim"], sliding_window=c["sliding_window"],
            **kw)).eval()
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**kw)).eval()
    with torch.no_grad():   # HF zeroes the qkv biases: make them live
        for lyr in hf.model.layers:
            for proj in (lyr.self_attn.q_proj, lyr.self_attn.k_proj,
                         lyr.self_attn.v_proj):
                proj.bias.uniform_(-0.5, 0.5)
    return hf


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, tmp_path_factory):
    """(name, cfg, hf model, state dict path: a file, and for llama a
    sharded directory too)."""
    name = request.param
    c = _cfg(name)
    hf = _hf(name, c)
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    single = str(tmp_path_factory.mktemp("st") / "model.safetensors")
    save_file(sd, single)
    paths = [single]
    if name == "llama":
        sharded = tmp_path_factory.mktemp("st_shards")
        keys = sorted(sd)
        for i, part in enumerate((keys[:len(keys) // 2],
                                  keys[len(keys) // 2:])):
            save_file({k: sd[k] for k in part},
                      str(sharded / f"model-0000{i + 1}-of-00002.safetensors"))
        paths.append(str(sharded))
    return name, c, hf, paths


def test_logits_match_hf_and_jax(family):
    name, c, hf, paths = family
    cfg, jcfg = LlamaConfig(**c), JaxLlamaConfig(**c)
    # T > window, so Mistral's sliding mask matters
    ids = np.random.RandomState(0).randint(0, c["vocab_size"], (1, 24))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits.numpy()
    for path in paths:
        sd = load_safetensors_state_dict(path)
        params = llama_params_from_state_dict(sd, cfg, device="cpu")
        got, _ = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids))
        np.testing.assert_allclose(got.numpy(), ref, **HF_TOL)
    want, _ = jax_llama.forward(jax_convert(hf.state_dict(), jcfg,
                                            dtype="float32"),
                                cfg=jcfg, input_ids=jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    # the family's own mechanism is live: without the window, or with the
    # biases zeroed, the logits move
    if name == "mistral":
        off, _ = llama.forward(params, cfg=dataclasses.replace(
            cfg, sliding_window=None), input_ids=torch.tensor(ids))
        assert not np.allclose(off.numpy(), got.numpy(), atol=1e-3)
    if name == "qwen2":
        assert "bq" in params["layers"]
        zeroed = dict(params, layers={
            k: torch.zeros_like(v) if k in ("bq", "bk", "bv") else v
            for k, v in params["layers"].items()})
        off, _ = llama.forward(zeroed, cfg=cfg, input_ids=torch.tensor(ids))
        assert not np.allclose(off.numpy(), got.numpy(), atol=1e-3)
    # the serving form: token-by-token decode over the ring equals the
    # full forward (the window and the biases through the cache path)
    cache = llama.init_kv_cache(cfg, batch=1, capacity=32, device="cpu")
    steps = []
    for t in range(ids.shape[1]):
        step, cache = llama.forward(params, cfg=cfg, kv_cache=cache,
                                    input_ids=torch.tensor(ids[:, t:t + 1]))
        steps.append(step[:, -1])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), got.numpy(),
                               atol=2e-4, rtol=2e-3)
    if name == "llama":
        # int8 weights from the converted tree stay close (cos > 0.999)
        q, _ = llama.forward(quant.quantize_llama_params(params), cfg=cfg,
                             input_ids=torch.tensor(ids))
        a, b = got[0, -1].numpy(), q[0, -1].numpy()
        assert (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_builder_llm_weights(tmp_path):
    """--llm_weights: the base is the converted checkpoint (the connector
    and LoRA random), in the builder's dtype."""
    c = dict(PROXY_SIZES["tiny"], rope_theta=500000.0, rms_norm_eps=1e-5)
    hf = _hf("llama", dict(c, dtype="float32"))
    d = tmp_path / "hf"
    d.mkdir()
    save_file({k: v.contiguous() for k, v in hf.state_dict().items()},
              str(d / "model.safetensors"))
    args = arguments.parse_args(["--model_size", "tiny", "--bf16", "false",
                                 "--llm_weights", str(d), "--output_dir",
                                 str(tmp_path / "out")])
    params, tok, cfg = builder.build_model_and_tokenizer(args, device="cpu")
    sd = hf.state_dict()
    torch.testing.assert_close(params["llama"]["embed"],
                               sd["model.embed_tokens.weight"])
    torch.testing.assert_close(params["llama"]["layers"]["w_up"][3],
                               sd["model.layers.3.mlp.up_proj.weight"].T)
    torch.testing.assert_close(params["llama"]["lm_head"],
                               sd["lm_head.weight"].T)
    assert set(params) == {"llama", "connector", "lora"}
    ids = np.random.RandomState(1).randint(0, 2048, (1, 9))
    got, _ = llama.forward(params["llama"], cfg=cfg.llama,
                           input_ids=torch.tensor(ids))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), ref, **HF_TOL)


def test_build_vision_params(tmp_path):
    """An HF SigLIP checkpoint (vision_model.-prefixed), a saved .pt tree,
    or random weights from the seed."""
    vc = VisionConfig(image_size=32, patch_size=16, hidden_size=32,
                      intermediate_size=64, num_layers=2, num_heads=2,
                      dtype="float32")
    from videollm_online_tpu_torch.core.config import live1_plus_config
    cfg = live1_plus_config(vision=vc, vision_hidden_size=32)
    torch.manual_seed(0)
    hf = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16)).eval()
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    f = str(tmp_path / "siglip.safetensors")
    save_file(sd, f)
    got = builder.build_vision_params(cfg, checkpoint=f, device="cpu")
    want = siglip_params_from_state_dict(sd, vc, device="cpu")
    pt = str(tmp_path / "tree.pt")
    torch.save(want, pt)
    again = builder.build_vision_params(cfg, checkpoint=pt, device="cpu")
    px = torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8)
    feats = [siglip.frame_features(p, siglip.preprocess(px, vc), vc, cfg)
             for p in (got, want, again)]
    torch.testing.assert_close(feats[0], feats[1])
    torch.testing.assert_close(feats[2], feats[1])
    with torch.no_grad():
        out = hf(pixel_values=siglip.preprocess(px, vc))
    torch.testing.assert_close(feats[0][:, 0], out.pooler_output,
                               **HF_TOL)
    r1 = builder.build_vision_params(cfg, seed=1, device="cpu")
    r2 = builder.build_vision_params(cfg, seed=1, device="cpu")
    torch.testing.assert_close(r1["layers"]["q"]["w"], r2["layers"]["q"]["w"])
    assert r1["pos_embed"].shape == (vc.num_patches, 32)
