"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs with the repository's conftest (which sets JAX up) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from videollm_online_tpu_torch.core.config import LiveConfig, LlamaConfig
from videollm_online_tpu_torch.models import live, llama
from videollm_online_tpu_torch.ops import decode_attention as da
from videollm_online_tpu_torch.serve.engine import LiveInferEngine
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

pytestmark = pytest.mark.cuda

B, HKV, G, D, C, L, LAYER = 2, 2, 4, 64, 1024, 2, 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(S, dtype, dev, seed=5, starts=(700, 37)):
    rng = np.random.RandomState(seed)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.from_numpy(rng.randn(B, HKV * G, S, D).astype(np.float32))
    shape = (L, B, HKV, C, D)
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
                for _ in range(2))
        sc = {n: torch.from_numpy((rng.rand(*shape[:-1]) / 64).astype(
            np.float32)).to(dev) for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(qdt)
                for _ in range(2))
        sc = {}
    q_pos = torch.from_numpy(
        np.stack([s + np.arange(S) for s in starts]).astype(np.int32))
    return q.to(qdt).to(dev), k.to(dev), v.to(dev), q_pos.to(dev), sc


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_kernel_matches_plain_on_card(card, dtype):
    """Tolerance 2e-2 for bf16 queries (bf16 or int8 K/V), 1e-5 for fp32."""
    tol = 1e-5 if dtype == "float32" else 2e-2
    for S, window in ((1, None), (14, None), (20, 96), (64, None)):
        q, k, v, q_pos, sc = _inputs(S, dtype, card)
        before = da.ring_decode_attention_layered.launches
        got = da.ring_decode_attention_layered(q, k, v, q_pos, LAYER,
                                               window=window, **sc)
        assert da.ring_decode_attention_layered.launches == before + 1
        want = da.ring_decode_attention_layered_reference(
            q, k, v, q_pos, LAYER, window=window, **sc)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_single_layer_form_and_empty_rows_on_card(card):
    q, k, v, q_pos, _ = _inputs(20, "float32", card, seed=6)
    q_pos[1] = -1                       # stream 1 sees nothing: output 0
    got = da.ring_decode_attention(q, k[0], v[0], q_pos)
    want = da.ring_decode_attention_reference(q, k[0], v[0], q_pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


def test_kernel_raises_on_what_it_does_not_take(card):
    q, k, v, q_pos, _ = _inputs(1, "bfloat16", card)
    with pytest.raises(TypeError):
        da.ring_decode_attention_layered(q.float(), k, v, q_pos, LAYER)
    with pytest.raises(ValueError, match="contiguous"):
        da.ring_decode_attention_layered(q, k.transpose(3, 4), v, q_pos,
                                         LAYER)
    big = torch.zeros((B, HKV * G, 65, D), dtype=q.dtype, device=card)
    with pytest.raises(ValueError, match="S <= 64"):
        da.ring_decode_attention_layered(big, k, v, q_pos, LAYER)


def test_engine_transcripts_kernel_equal_plain_on_card(card):
    """A small fp32 engine whose head size takes the kernel serves the same
    transcripts through K1 as through the plain attention."""
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    cfg = LiveConfig(llama=lcfg, lora=None, vision_hidden_size=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(max_response_tokens=20)
    gen = torch.Generator(device=card).manual_seed(0)
    params = {"llama": llama.init_params(gen, cfg.llama, device=card),
              "connector": live.init_connector(gen, cfg, device=card)}
    feats = np.random.RandomState(0).randn(
        16, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)

    def drive(**kw):
        eng = LiveInferEngine(params, tok, cfg, kv_capacity=2048,
                              spec_decode=True, device=card, **kw)
        eng.load_video(feats)
        out = []
        for i in range(16):
            if i % 8 == 0:
                eng.input_query_stream("narrate?", video_time=i / 2)
            if i % 4 == 3:
                eng.input_video_stream(i / 2)
            while True:
                q, r = eng()
                if r is None:
                    break
                out.append((q, r))
        return out

    before = da.ring_decode_attention_layered.launches
    with_k1 = drive()
    assert da.ring_decode_attention_layered.launches > before
    assert with_k1 == drive(attn_impl=llama._attention)
    assert with_k1
