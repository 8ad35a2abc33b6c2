"""The port's LiveInferEngine against the JAX LiveInferEngine.

Same tiny config, the same weights (carried over from the JAX params by
``params_from_numpy``) and the same frames and queries: the transcripts
must be equal byte for byte, with spec decode off and on, for fp32, int8
and mixed int4 (``quant.quantize_live_params``, ``bits`` 8 and 4) weights;
on the CPU both packages take the dequantizing route for int4. The JAX engine runs its
blocking path (``fused_respond=False``), the one the port carries.
"""

import numpy as np
import pytest

import jax
import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import quant as jax_quant
from videollm_online_tpu.serve.engine import LiveInferEngine as JaxEngine
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import live, llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.serve.engine import LiveInferEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

# (seed, threshold, gate bias, frame feed times, queries, n_frames,
#  pin the interval id to the model's favourite token)
SCENARIOS = {
    # random weights fire the gate on almost every frame: start prefill,
    # ']\nAssistant:' prompts, EOS reopen prepends
    "always_fire": (0, 0.725, 0.0, [0.0, 0.5, 1.0, 1.5, 2.0], [], 6, False),
    "with_queries": (1, 0.725, 0.0, [0.0, 0.5, 1.0, 1.5],
                     [(0.4, "what is happening?"), (1.2, "and now?")], 5,
                     False),
    # multi-frame ','-chains until the gate diverges
    "streaming_interval": (0, 0.0, 0.0, [0.0, 0.5, 1.0, 1.5, 2.0, 2.5],
                           [(2.2, "ok?")], 6, True),
    # the main path at tiny size: frames arrive 8 at a time (chunked
    # ingest), a query every 8 frames, the gate held by a +30 bias
    "main_path": (2, 0.725, 30.0, [3.5, 7.5, 11.5, 15.5],
                  [(0.0, "narrate?"), (4.0, "narrate?"), (8.0, "narrate?"),
                   (12.0, "narrate?")], 16, False),
}


def _configs(threshold, bias, interval_id=None):
    out = []
    for make_cfg, make_tok, bytes_tok in (
            (jax_tiny_cfg, JaxTokenizer, JaxBytes),
            (tiny_live_config, LiveTokenizer, ByteTokenizer)):
        tok = make_tok(bytes_tok(), make_cfg())
        cfg = tok.cfg.replace(frame_token_interval_threshold=threshold,
                              max_response_tokens=20, gate_logit_bias=bias)
        if interval_id is not None:
            cfg = cfg.replace(frame_token_interval_id=interval_id)
        out.append((cfg, tok))
    return out


def _favourite_token(params, cfg, tok, feats):
    """The model's argmax after the system prompt and the first frame."""
    ids = tok.apply_chat_template(
        [{"role": "system", "content": cfg.system_prompt}], tokenize=True,
        add_stream_prompt=True)
    emb = llama.embed_tokens(params["llama"], torch.tensor([ids]), cfg.llama)
    frame = live.visual_embed(params, torch.from_numpy(feats[:1]), cfg)
    logits, _ = llama.forward(params["llama"], cfg=cfg.llama,
                              inputs_embeds=torch.cat([emb, frame[None]], 1),
                              last_logit_only=True)
    return int(torch.argmax(logits[0, -1]))


def _drive(engine, feats, frame_times, queries):
    engine.load_video(feats)
    transcripts, qi = [], 0
    for t in frame_times:
        while qi < len(queries) and queries[qi][0] <= t:
            engine.input_query_stream(queries[qi][1],
                                      video_time=queries[qi][0])
            qi += 1
        engine.input_video_stream(t)
        while True:
            q, r = engine()
            if r is None:
                break
            transcripts.append((q, r))
    return transcripts


# every scenario with fp32 weights; int8 and int4 weights on the two
# scenarios that reach every engine step (each case compiles a fresh JAX
# engine)
CASES = ([(name, "fp32") for name in SCENARIOS]
         + [("always_fire", "q8"), ("main_path", "q8"),
            ("always_fire", "q4"), ("main_path", "q4")])


@pytest.mark.parametrize("spec", [False, True], ids=["greedy", "spec"])
@pytest.mark.parametrize("scenario,weights", CASES)
def test_engine_transcripts_equal_jax(scenario, weights, spec):
    seed, thr, bias, times, queries, n_frames, pin = SCENARIOS[scenario]
    (jcfg, jtok), (cfg, tok) = _configs(thr, bias)
    jparams = jax_live.init_params(jax.random.PRNGKey(seed), jcfg)
    if weights in ("q8", "q4"):
        jparams = jax_quant.quantize_live_params(
            jparams, bits=8 if weights == "q8" else 4)
    jparams = jax.device_get(jparams)
    params = params_from_numpy(jparams, device="cpu")
    feats = np.random.RandomState(seed).randn(
        n_frames, cfg.frame_num_tokens, cfg.vision_hidden_size
    ).astype(np.float32)
    if pin:
        fav = _favourite_token(params, cfg, tok, feats)
        assert fav != cfg.eos_token_id
        (jcfg, jtok), (cfg, tok) = _configs(thr, bias, interval_id=fav)

    jeng = JaxEngine(jparams, jtok, jcfg, kv_capacity=1024,
                     fused_respond=False, multi_respond=False,
                     spec_decode=spec)
    eng = LiveInferEngine(params, tok, cfg, kv_capacity=1024,
                          spec_decode=spec, device="cpu")
    want = _drive(jeng, feats, times, queries)
    got = _drive(eng, feats, times, queries)
    assert got == want
    assert len(got) >= 1
    assert eng._host_offset == int(jeng.cache.offset[0])
    assert eng._pending_prepend == jeng._pending_prepend
    if spec:
        np.testing.assert_array_equal(eng.spec_stats(), jeng.spec_stats())
