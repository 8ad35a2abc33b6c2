"""The port's LiveInferEngine options against the JAX engine's blocking path.

Each case builds both engines on the same tiny fp32 weights (carried over
by ``params_from_numpy``; the SigLIP tower by ``vision_params_from_numpy``)
and drives them with the same frames and queries (``fused_respond=False``,
``multi_respond=False`` on the JAX side). Transcripts must be equal byte
for byte, and with ``stream_tokens`` so must every ``on_delta`` segment;
the ring offset, the pending prepend, ``stats()`` and the spec stats must
agree too.
The cases are those of the JAX package's own tests: raw uint8 frames
through the tower (test_engine_extras.py::test_raw_pixel_video_path, its
embeddings also held to the JAX engine's encoder within fp32 noise) with
greedy 2-token segments (test_stream_tokens.py::
test_stream_tokens_unfused_path), the compacted ring (test_engine_extras.py
::test_stream_window_compaction_matches_uncompacted), the int8 ring
(test_kv_quant.py's engine cases), forced replay (test_spec_decode.py::
test_engine_spec_forced_script_transcripts), a Mistral-style window
(test_serve_engine.py::test_engine_matches_oracle_sliding_window), and all
of vision (on an ``encoder_device``), int8 ring, compaction, segments and
spec decode at once. The
int8 ring is byte-equal too: both packages quantize K/V with the same
arithmetic (bit-identical codes and scales) and dequantize before the same
fp32 attention.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import siglip as jax_siglip
from videollm_online_tpu.serve.engine import LiveInferEngine as JaxEngine

from videollm_online_tpu_torch.models import live
from videollm_online_tpu_torch.models.bridge import (
    params_from_numpy, vision_params_from_numpy)
from videollm_online_tpu_torch.serve.engine import LiveInferEngine

from test_torch_engine import _configs, _drive

# name: (seed, threshold, gate bias, budget, frame feed times, queries,
#        n_frames, engine options, raw pixels)
CASES = {
    "vision_segments": (0, 0.725, 0.0, 8, [0.5, 1.0, 2.0],
                        [(0.6, "what now?")], 5,
                        dict(kv_capacity=512, stream_tokens=2), True),
    "stream_window": (5, 0.725, 0.0, 12, [i / 2 for i in range(32)],
                      [(4.0, "what is happening?")], 32,
                      dict(kv_capacity=640, stream_window=64), False),
    "kv_int8": (0, 0.725, 0.0, 20, [i / 2 for i in range(12)],
                [(0.5, "q1?"), (3.0, "q2?")], 12,
                dict(kv_capacity=4096, kv_quant="int8"), False),
    "forced_script": (2, 0.725, 30.0, 24, [i * 0.5 for i in range(12)],
                      [(t, "narrate?") for t in (0.5, 3.5)], 12,
                      dict(kv_capacity=4096, spec_decode=True), False),
    "sliding_window": (4, 0.725, 0.0, 20, [0.0, 0.5, 1.0, 1.5, 2.0],
                       [(1.0, "now?")], 6, dict(kv_capacity=1024), False),
    "all": (1, 0.725, 0.0, 8, [i / 2 for i in range(16)],
            [(1.0, "what now?")], 16,
            dict(kv_capacity=512, kv_quant="int8", stream_window=96,
                 stream_tokens=4, spec_decode=True), True),
}
SCRIPT = ["You look around.", "You pick up the knife.", "You stir the bowl."]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Deltas(list):
    def __call__(self, delta, done):
        self.append((delta, done))


def _pair(name):
    """(jax engine, port engine, frames) of one case."""
    seed, thr, bias, budget, _, _, n, opts, pixels = CASES[name]
    (jcfg, jtok), (cfg, tok) = _configs(thr, bias)
    jcfg = jcfg.replace(max_response_tokens=budget)
    cfg = cfg.replace(max_response_tokens=budget)
    if name == "sliding_window":
        jcfg = jcfg.replace(llama=dataclasses.replace(jcfg.llama,
                                                      sliding_window=48))
        cfg = cfg.replace(llama=dataclasses.replace(cfg.llama,
                                                    sliding_window=48))
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(seed),
                                                  jcfg))
    params = params_from_numpy(jparams, device="cpu")
    rng = np.random.RandomState(seed)
    jkw, kw = dict(opts), dict(opts)
    if pixels:
        jvp = jax.device_get(jax_siglip.init_params(jax.random.PRNGKey(1),
                                                    jcfg.vision))
        jkw["vision_params"] = jvp
        kw["vision_params"] = vision_params_from_numpy(jvp, device="cpu")
        r = cfg.vision.image_size
        frames = rng.randint(0, 256, (n, 3, r, r)).astype(np.uint8)
    else:
        frames = rng.randn(n, cfg.frame_num_tokens,
                           cfg.vision_hidden_size).astype(np.float32)
    if name == "all":
        # the port's tower on a device named apart from the decoder's (one
        # CPU here, so the same one; the JAX engine keeps its default)
        kw["encoder_device"] = "cpu"
    if name == "forced_script":
        script = np.full((3, budget), cfg.eos_token_id, np.int32)
        for r, s in enumerate(SCRIPT):
            ids = list(tok.encode(s))[:budget - 1]
            script[r, :len(ids)] = ids
        jkw["spec_forced_script"] = kw["spec_forced_script"] = script
    if "stream_tokens" in opts:
        jkw["on_delta"], kw["on_delta"] = _Deltas(), _Deltas()
    jeng = JaxEngine(jparams, jtok, jcfg, fused_respond=False,
                     multi_respond=False, **jkw)
    eng = LiveInferEngine(params, tok, cfg, device="cpu", **kw)
    return jeng, eng, frames


@pytest.mark.parametrize("name", list(CASES))
def test_option_transcripts_equal_jax(name):
    _, _, _, _, times, queries, _, opts, _ = CASES[name]
    jeng, eng, frames = _pair(name)
    want = _drive(jeng, frames, times, queries)
    got = _drive(eng, frames, times, queries)
    assert got == want
    assert len(got) >= 1
    assert eng._host_offset == int(jeng.cache.offset[0])
    assert int(eng.cache.pos_base[0]) == int(jeng.cache.pos_base[0])
    assert eng._pending_prepend == jeng._pending_prepend
    assert eng.stats() == jeng.stats()
    np.testing.assert_array_equal(eng.spec_stats(), jeng.spec_stats())
    if "stream_window" in opts:
        # the ring was compacted, so K1 ran over a compacted ring
        assert int(eng.cache.pos_base[0]) > 0
    if "kv_quant" in opts:
        assert eng.cache.k.dtype == torch.int8
    if "stream_tokens" in opts:
        assert eng.on_delta == jeng.on_delta
        # some response spanned more than one segment
        assert sum(not done for _, done in eng.on_delta) >= 1
    if CASES[name][8]:
        # the tower + connector embeddings, on a shape the JAX engine's
        # encoder compiled during the drive (the first feed's 2 frames)
        px = frames[:2]
        np.testing.assert_allclose(
            live.pixels_to_embeds(eng.vision_params, eng.params,
                                  torch.from_numpy(px), eng.cfg).numpy(),
            np.asarray(jeng._encode_frames(jeng.vision_params, jeng.params,
                                           jnp.asarray(px))),
            atol=2e-5, rtol=2e-4)
    if name == "forced_script":
        resps = [r.split("Assistant:", 1)[1] for _, r in got]
        assert resps == [SCRIPT[k % 3] for k in range(len(resps))]
        assert int(eng._sstats[2]) == len(resps)


def _tiny_engine(**kw):
    _, (cfg, tok) = _configs(0.725, 0.0)
    cfg = cfg.replace(max_response_tokens=8)
    gen = torch.Generator().manual_seed(0)
    params = live.init_params(gen, cfg, device="cpu")
    return LiveInferEngine(params, tok, cfg, device="cpu", **kw), cfg


def test_stats_threshold_swap_backoff_flush():
    eng, cfg = _tiny_engine(kv_capacity=512, spec_decode=True)
    st0 = eng.stats()
    assert st0["offset"] == 0 and st0["kv_capacity"] == 512
    feats = np.random.RandomState(0).randn(
        4, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)
    first = _drive(eng, feats, [0.5, 1.0, 1.5], [(0.5, "what now?")])
    st = eng.stats()
    assert st["offset"] == eng._host_offset > 0
    assert st["queued_queries"] == 0 and st["video_time"] == 1.5
    assert eng.flush() == []

    # a threshold above 1 makes every gate fire: one response per frame
    eng.reset()
    eng.set_threshold(1.01)
    assert eng.cfg.frame_token_interval_threshold == 1.01
    fired = _drive(eng, feats, [0.0, 0.5, 1.0, 1.5], [])
    assert len(fired) == 4

    # swap_params: new weights serve the next step, as a fresh engine
    params2 = live.init_params(torch.Generator().manual_seed(7), cfg,
                               device="cpu")
    eng.reset()
    eng.set_threshold(cfg.frame_token_interval_threshold)
    eng.swap_params(params2)
    fresh = LiveInferEngine(params2, eng.tokenizer, cfg, kv_capacity=512,
                            spec_decode=True, device="cpu")
    times, queries = [0.5, 1.0, 1.5], [(0.5, "what now?")]
    assert _drive(eng, feats, times, queries) == _drive(fresh, feats, times,
                                                        queries)
    bad = dict(params2, connector={"fc1": params2["connector"]["fc1"]})
    with pytest.raises(ValueError, match="structure"):
        eng.swap_params(bad)
    with pytest.raises(ValueError, match="shape or dtype"):
        eng.swap_params(dict(params2, connector={
            k: {n: t.double() for n, t in v.items()}
            for k, v in params2["connector"].items()}))
    assert first

    # spec backoff: no-op above the acceptance floor, greedy below it
    assert eng.maybe_backoff_spec(min_steps=10**6) == (False, [])
    backed, drained = eng.maybe_backoff_spec(min_steps=1,
                                             min_tokens_per_step=100.0)
    assert backed and drained == [] and not eng.spec_decode


@pytest.mark.parametrize("mode", ["fused_respond", "multi_respond",
                                  "pipelined", "speculative"])
def test_dispatch_modes_refused(mode):
    """Each of the JAX engine's dispatch modes builds and serves a short
    stream (a query, gate fires) with the blocking engine's transcript;
    the modes the JAX engine excludes raise."""
    feats = np.random.RandomState(3).randn(6, 10, 32).astype(np.float32)
    times, queries = [i / 2 for i in range(6)], [(1.0, "what now?")]
    off = dict(fused_respond=False, multi_respond=False)
    eng, _ = _tiny_engine(kv_capacity=1024, **{**off, mode: True})
    blocking, _ = _tiny_engine(kv_capacity=1024, **off)
    got = _drive(eng, feats, times, queries) + eng.flush()
    assert got == _drive(blocking, feats, times, queries)
    assert len(got) >= 2 and eng.stats()["offset"] == blocking._host_offset
    if mode in ("pipelined", "speculative"):
        with pytest.raises(ValueError, match="exclude"):
            _tiny_engine(pipelined=True, speculative=True)
        with pytest.raises(ValueError, match="stream_tokens"):
            _tiny_engine(stream_tokens=4, **{mode: True})


@pytest.mark.parametrize("kw,match", [
    (dict(stream_tokens=3), "divide"),
    (dict(spec_forced_script=np.zeros((1, 8), np.int32)), "spec_decode"),
    (dict(spec_decode=True, spec_forced_script=np.zeros((1, 7), np.int32)),
     "script must be"),
    (dict(stream_window=64, kv_capacity=256), "too small"),
    (dict(kv_quant="int4"), "kv_quant")])
def test_option_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        _tiny_engine(**kw)


def test_raw_pixels_need_vision_params_and_segments_size_drafts():
    eng, cfg = _tiny_engine(spec_decode=True, stream_tokens=4)
    assert eng.spec_draft == 3 and eng.max_new == 4
    eng.load_video(np.zeros((2, 3, 32, 32), np.uint8))
    with pytest.raises(ValueError, match="vision_params"):
        eng.input_video_stream(0.0)


# ------------------------------------------------------------ MultiStream
class _StreamDeltas(list):
    def __call__(self, i, delta, done):
        self.append((i, delta, done))


def test_multistream_segments_and_pixels_equal_jax():
    """MultiStreamEngine with stream_tokens 4 and spec decode (the case of
    the JAX package's test_multistream_stream_tokens.py::
    test_ms_stream_tokens_composes_with_spec_decode) over raw uint8 frames
    through the tower: per-stream step() results and every on_delta
    segment equal the JAX engine's blocking tick; flush() leaves no
    response open."""
    from videollm_online_tpu.serve.multistream import (
        MultiStreamEngine as JaxMultiStream)
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from test_torch_multistream import _feed_schedule

    (jcfg, jtok), (cfg, tok) = _configs(0.725, 0.0)
    jcfg = jcfg.replace(max_response_tokens=16)
    cfg = cfg.replace(max_response_tokens=16)
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(3),
                                                  jcfg))
    kw = dict(num_streams=3, kv_capacity=2048, chunk_frames=4,
              stream_tokens=4, spec_decode=True)
    jkw, pkw = dict(kw, on_delta=_StreamDeltas()), dict(
        kw, on_delta=_StreamDeltas())
    rng = np.random.RandomState(11)
    jvp = jax.device_get(jax_siglip.init_params(jax.random.PRNGKey(1),
                                                jcfg.vision))
    jkw["vision_params"] = jvp
    pkw["vision_params"] = vision_params_from_numpy(jvp, device="cpu")
    r = cfg.vision.image_size
    feats = [rng.randint(0, 256, (8, 3, r, r)).astype(np.uint8)
             for _ in range(3)]
    queries = {0: (1.2, "what now?"), 2: (0.75, "anything?")}
    schedule = [0.0, 1.0, 2.0, 3.5, 5.5]
    jms = JaxMultiStream(jparams, jtok, jcfg, fused=False, **jkw)
    ms = MultiStreamEngine(params_from_numpy(jparams, device="cpu"), tok,
                           cfg, device="cpu", **pkw)
    assert ms.spec_draft == jms.spec_draft == 3
    want = _feed_schedule(jms, feats, queries, schedule)
    got = _feed_schedule(ms, feats, queries, schedule)
    assert got == want and any(got)
    assert ms.on_delta == jms.on_delta
    assert max(sum(1 for j, _, d in ms.on_delta if j == i and not d)
               for i in range(3)) >= 1, "no response spanned two segments"
    assert ms.flush() == [[], [], []]
    assert ms.stats()["open_responses"] == 0 and not ms.pending()
    np.testing.assert_array_equal(ms.spec_stats(), jms.spec_stats())
    assert np.asarray(ms._host_offsets).tolist() == \
        np.asarray(jms._host_offsets).tolist()


def test_cli_serves_an_avi_through_the_tower(tmp_path, monkeypatch, capsys):
    """serve/cli.py end to end on a video file: an .avi written by the
    port's write_avi, decoded by the first-party reader, encoded by a
    random tower (--with_vision, at a small width here), served over the
    int8 ring in 4-token segments with spec decode."""
    from videollm_online_tpu_torch.core.config import VisionConfig
    from videollm_online_tpu_torch.data import avi
    from videollm_online_tpu_torch.serve import cli

    small = VisionConfig(image_size=32, patch_size=16, hidden_size=32,
                         intermediate_size=64, num_layers=2, num_heads=2,
                         dtype="float32")
    make = cli.live1_plus_config
    monkeypatch.setattr(cli, "live1_plus_config", lambda **kw: make(
        **kw).replace(vision=small, vision_hidden_size=32,
                      frame_resolution=32, max_response_tokens=8))
    frames = np.random.RandomState(0).randint(0, 256, (6, 40, 56, 3),
                                              dtype=np.uint8)
    video = str(tmp_path / "clip.avi")
    avi.write_avi(video, frames, fps=2.0)
    out = tmp_path / "history.json"
    history = cli.main(["--device", "cpu", "--model_size", "tiny",
                        "--dtype", "float32", "--video", video,
                        "--with_vision", "--kv_quant", "int8",
                        "--stream_tokens", "4", "--spec_decode",
                        "--num_ticks", "6", "--warmup_ticks", "1",
                        "--output", str(out)])
    printed = capsys.readouterr().out
    assert "Average Processing FPS:" in printed
    assert history["average_processing_fps"] > 0
    assert any(m["role"] == "assistant" for m in history["messages"])
