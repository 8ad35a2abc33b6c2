"""Tensor-parallel serving: the port's engines on params cut ``tp``.

The JAX package's tests/test_sharding.py drives ``LiveInferEngine`` and
``MultiStreamEngine`` with params sharded over model=4 and asserts the
transcripts equal the single-device ones. Here the same scenarios (the
tiny config, the same random weights carried over by ``bridge.py``, the
same frames and queries) run on the port's engines in ``gloo`` worlds of 2
and 4 ranks on the CPU (``tests/_torch_dist.py``), each rank holding its
``shard_params(..., policy="tp")`` tree under ``maybe_mesh``; every rank's
transcripts must equal the JAX single-device engine's, byte for byte
(fp32). At model=4 the tiny config's 2 kv heads are replicated (each rank
keeps the one its query head reads). The JAX multistream test runs its
pipelined tick; the port runs its blocking tick and its pipelined tick
(depth 2), ring and paged, on every rank. int8 weights and spec
decode under TP are held to the port's own unsharded engine (the port's
int8 engine equals JAX's in tests/test_torch_engine.py). The int4 serving
layout (q4c columns repacked to each rank's pairing) and the paged pool's
local kv heads are held to the unsharded forward by the first logits of a
small decoder whose int4 scale groups stay whole on every rank (the tiny
config's F of 128 is one group), within LOGIT_REL: fp32 partial products
summed over the model axis in another order.
"""

import numpy as np
import pytest

import jax

import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.serve.engine import LiveInferEngine as JaxEngine
from videollm_online_tpu.serve.multistream import (
    MultiStreamEngine as JaxMultiStream)
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes

import _torch_parallel_workers as workers
from _torch_dist import start_worlds

ENGINE_CASES = ((None, False), (8, True))
LOGIT_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """(JAX single-device transcripts of the engine and the multistream
    engine, every world's results); the worlds run while JAX does."""
    tok = JaxTokenizer(JaxBytes(), jax_tiny_cfg())
    cfg = tok.cfg.replace(frame_token_interval_threshold=0.725,
                          max_response_tokens=12)
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(9),
                                                  cfg))
    feats = np.random.RandomState(2).randn(
        6, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)
    rng = np.random.RandomState(5)
    ms_feats = [rng.randn(8, cfg.frame_num_tokens,
                          cfg.vision_hidden_size).astype(np.float32)
                for _ in range(2)]
    models = (2, 4)
    wait = start_worlds(
        [(workers.many, model,
          ([("tp_engine", (model, jparams, feats, ENGINE_CASES)),
            ("tp_multistream", (model, jparams, ms_feats)),
            ("tp_first_logits", (model,))],))
         for model in models], tmp_path_factory.mktemp("tp"))

    eng = JaxEngine(jparams, tok, cfg, kv_capacity=1024)
    eng.load_video(feats)
    eng.input_query_stream("what now?", video_time=1.0)
    ref = []
    for i in range(feats.shape[0]):
        eng.input_video_stream(i / eng.frame_fps)
        while True:
            q, r = eng()
            if r is None:
                break
            ref.append((q, r))

    ms = JaxMultiStream(jparams, tok, cfg, num_streams=2, kv_capacity=1024,
                        chunk_frames=4)
    for i in range(2):
        ms.input_frames(i, 0.0, ms_feats[i])
    ms.input_query(0, "what now?", video_time=1.2)
    for _ in range(64):
        ms.step()
        if not ms.pending():
            break
    return ref, ms.transcripts, dict(zip(models, wait()))


@pytest.mark.parametrize("model", [2, 4])
def test_tp_engine_transcripts_equal_jax_single_device(scenario, model):
    ref = scenario[0]
    assert len(ref) >= 1
    for rank, (engine, _, _) in enumerate(scenario[2][model]):
        got, kv_heads, _ = engine[(None, False)]
        assert got == ref, rank
        assert kv_heads == max(2 // model, 1)


@pytest.mark.parametrize("model", [2, 4])
def test_tp_engine_int8_spec_equals_unsharded(scenario, model):
    for engine, _, _ in scenario[2][model]:
        got, _, single = engine[(8, True)]
        assert got == single and len(got) >= 1


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("paged", [True, False])
def test_tp_multistream_transcripts_equal_jax_single_device(
        scenario, model, paged):
    ref = scenario[1]
    assert sum(len(t) for t in ref) >= 1
    for rank, (_, ms, _) in enumerate(scenario[2][model]):
        transcripts, kv_heads, _ = ms[paged, False]
        assert transcripts == ref, rank
        assert kv_heads == max(2 // model, 1)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("paged", [True, False])
def test_tp_multistream_pipelined_transcripts_equal_jax_single_device(
        scenario, model, paged):
    """The JAX test's own mode: the pipelined tick under the mesh. Every
    rank takes the same dispatch and rollback decisions (their collectives
    would part otherwise and the world would hang), with two ticks in
    flight and some rolled back, and serves the JAX single-device
    transcripts."""
    ref = scenario[1]
    stats = []
    for rank, (_, ms, _) in enumerate(scenario[2][model]):
        transcripts, kv_heads, st = ms[paged, True]
        assert transcripts == ref, rank
        assert kv_heads == max(2 // model, 1)
        stats.append(st)
    assert all(st == stats[0] for st in stats)
    assert stats[0]["max_inflight"] == 2 and stats[0]["rolled_back"] > 0


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("cache", ["ring", "paged"])
def test_tp_int4_first_logits_equal_unsharded(scenario, model, cache):
    for rank, (_, _, first) in enumerate(scenario[2][model]):
        rel, kv_heads = first[cache]
        assert rel <= LOGIT_REL, (rank, rel)
        assert kv_heads == max(2 // model, 1)
