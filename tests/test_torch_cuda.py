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
from videollm_online_tpu_torch.models import live, llama, quant
from videollm_online_tpu_torch.ops import decode_attention as da
from videollm_online_tpu_torch.ops import flash_attention as fa
from videollm_online_tpu_torch.ops import fused_mlp as fm
from videollm_online_tpu_torch.ops import paged_attention as pa
from videollm_online_tpu_torch.serve.engine import LiveInferEngine
from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
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


def _inputs(S, dtype, dev, seed=5, starts=(700, 37), d=D):
    rng = np.random.RandomState(seed)
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.from_numpy(rng.randn(B, HKV * G, S, d).astype(np.float32))
    shape = (L, B, HKV, C, d)
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
    """Tolerance, elementwise and on the relative norm error, chip_smoke.py's
    K1_TOL, set from its readings at the 8B shapes: bf16 queries (bf16 or
    int8 K/V) atol 2e-3 (a typical output is about 0.01 to 0.05) and rtol
    2e-2 (an ulp of the large values), relative norm 5e-3; fp32 atol 1e-6,
    rtol 1e-5, relative norm 5e-6."""
    atol, rtol, rel = ((1e-6, 1e-5, 5e-6) if dtype == "float32"
                       else (2e-3, 2e-2, 5e-3))
    # rows (G * S) not a multiple of 16 at S 7 and 21; windows whose edge
    # and first visible slot fall inside a 64-slot tile; d 64 and 128
    for S, window, d in ((1, None, D), (14, None, D), (20, 96, D),
                         (64, None, D), (7, None, D), (21, 100, D),
                         (1, 33, 128), (21, None, 128), (64, 300, 128)):
        q, k, v, q_pos, sc = _inputs(S, dtype, card, d=d)
        before = da.ring_decode_attention_layered.launches
        got = da.ring_decode_attention_layered(q, k, v, q_pos, LAYER,
                                               window=window, **sc)
        assert da.ring_decode_attention_layered.launches == before + 1
        want = da.ring_decode_attention_layered_reference(
            q, k, v, q_pos, LAYER, window=window, **sc)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert float((got.float() - want.float()).norm()
                     / want.float().norm()) <= rel


def test_single_layer_form_and_empty_rows_on_card(card):
    q, k, v, q_pos, _ = _inputs(20, "float32", card, seed=6)
    q_pos[1] = -1                       # stream 1 sees nothing: output 0
    got = da.ring_decode_attention(q, k[0], v[0], q_pos)
    want = da.ring_decode_attention_reference(q, k[0], v[0], q_pos)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[1].any()


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_tensor_core_decode_kernels_repeat_bits_on_card(card, kv, monkeypatch):
    """K1 and K3 on the tensor cores (bf16 q): the same input twice gives
    equal bits, with the wrapper's split count (partials merged in a second
    launch) and with one split (the output written directly), at S 1 (4
    rows, slices of each tile) and S 21 (84 rows, two row blocks); each
    held to the plain version at chip_smoke.py's K1_TOL / K3_TOL."""
    for one_split in (False, True):
        if one_split:
            monkeypatch.setattr(da, "num_splits", lambda *args: 1)
        for S in (1, 21):
            q, k, v, q_pos, sc = _inputs(S, kv, card, seed=7, d=128)
            assert da.kernel_design(q.dtype, 128) == "tensor cores"
            got = da.ring_decode_attention_layered(q, k, v, q_pos, LAYER,
                                                   window=200, **sc)
            assert torch.equal(got, da.ring_decode_attention_layered(
                q, k, v, q_pos, LAYER, window=200, **sc))
            want = da.ring_decode_attention_layered_reference(
                q, k, v, q_pos, LAYER, window=200, **sc)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                                       rtol=2e-2)
            q, k, v, table, q_pos, sc = _paged_inputs(S, kv, card, d=128,
                                                      page=32)
            got = pa.paged_attention(q, k, v, table, q_pos, LAYER, **sc)
            assert torch.equal(got, pa.paged_attention(q, k, v, table, q_pos,
                                                       LAYER, **sc))
            want = pa.paged_attention_reference(q, k, v, table, q_pos, LAYER,
                                                **sc)
            torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                                       rtol=2e-2)


def test_decode_library_refuses_other_pairings_on_card(card):
    """The library refuses a design that does not take (dtype, d): bf16 d
    128 on FMA, fp32 on the tensor cores, d 256 on the tensor cores; and a
    slice count the tensor-core kernel does not have (2)."""
    stream = torch.cuda.current_stream(card).cuda_stream
    q, k, v, q_pos, _ = _inputs(1, "bfloat16", card, d=128)
    out = torch.empty_like(q)
    part = torch.empty(64 * B * HKV * G * 128 * 2, device=card)
    for d, is_bf16, design, slices in ((128, 1, 0, 4), (128, 0, 1, 4),
                                       (256, 1, 1, 4), (128, 1, 1, 2)):
        # q, k, v, ks, vs, q_pos, out, part_acc, part_ml, B, Hkv, S, rows,
        # d, C, layer, window, nsplit, q_dtype, kv_int8, design, slices
        assert da._kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
            q_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            part.data_ptr(), B, HKV, 1, G, d, C, LAYER, 0, 1, is_bf16, 0,
            design, slices, stream) != 0


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


def test_to_device_and_deferred_read_on_card(card):
    """Host tensors reach the card by pinned non-blocking copies, expanded
    views included, with no host synchronisation; two readbacks in flight
    keep their own buffers."""
    from videollm_online_tpu_torch.core.device import DeferredRead, to_device
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = to_device(torch.arange(4)[None].expand(3, 4), card)
        reads = [DeferredRead(x * k) for k in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(reads[1].read(), 2 * torch.arange(4).expand(3, 4))
    assert torch.equal(reads[0].read(), torch.arange(4).expand(3, 4))


@pytest.mark.parametrize("mode,feed", [("speculative", 1),
                                       ("pipelined", 4)])
def test_dispatch_modes_on_card(card, mode, feed, monkeypatch):
    """The dispatch-ahead drivers on the card serve the blocking engine's
    transcripts, and their fills make no host synchronisation
    (``set_sync_debug_mode("error")`` raises on one)."""
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
    name = "_spec_fill" if mode == "speculative" else "_pipe_fill"
    fill = getattr(LiveInferEngine, name)

    def checked(self, *a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fill(self, *a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(LiveInferEngine, name, checked)

    def drive(**kw):
        eng = LiveInferEngine(params, tok, cfg, kv_capacity=2048,
                              spec_decode=True, device=card, **kw)
        eng.load_video(feats)
        out = []
        for i in range(16):
            if i % 8 == 0:
                eng.input_query_stream("narrate?", video_time=i / 2)
            if i % feed == feed - 1:
                eng.input_video_stream(i / 2)
            while True:
                q, r = eng()
                if r is None:
                    break
                out.append((q, r))
        return out + eng.flush(), eng

    got, eng = drive(**{mode: True})
    assert got == drive()[0] and got
    assert eng.dispatch_stats()["max_inflight"] >= 1


@pytest.mark.parametrize("dtype,shape,kw", [
    ("bfloat16", (1, 8, 2, 512, 512, 128), {}),
    ("float32", (2, 4, 4, 256, 256, 64), {}),
    ("bfloat16", (1, 4, 2, 300, 300, 256), {"window": 128}),
    ("float32", (1, 4, 2, 200, 456, 128), {"q_offset": 256}),
    ("bfloat16", (1, 4, 1, 384, 384, 64), {"kv_valid": 300}),
    ("bfloat16", (1, 8, 2, 1000, 1000, 128), {}),
    ("bfloat16", (2, 4, 2, 256, 456, 128), {"q_offset": 200}),
    ("bfloat16", (2, 8, 2, 384, 384, 64), {}),
    ("bfloat16", (1, 4, 2, 512, 512, 128), {"window": 100, "kv_valid": 400}),
])
def test_flash_kernels_match_plain_on_card(card, dtype, shape, kw):
    """K2's forward, dK/dV and dQ kernels against their plain versions, on
    the plain forward's out and lse. Tolerance, elementwise and on the
    relative norm error, chip_smoke.py's: bf16 atol 2e-3 (well below a
    typical value) and rtol 2e-2 (an ulp of the large values), relative
    norm 5e-3; fp32 atol 1e-5 and rtol 1e-4 (dK/dV sum up to G * T
    products in another order), relative norm 1e-5; lse 1e-4."""
    B, Hq, Hkv, T, S, d = shape
    tdt = getattr(torch, dtype)
    atol, rtol, rel = ((2e-3, 2e-2, 5e-3) if dtype == "bfloat16"
                       else (1e-5, 1e-4, 1e-5))
    rng = np.random.RandomState(sum(shape))
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        tdt).to(card) for s in ((B, Hq, T, d), (B, Hkv, S, d),
                                (B, Hkv, S, d), (B, Hq, T, d)))
    scale = 1.0 / d ** 0.5
    before = (fa.flash_fwd.launches, fa.flash_dkdv.launches,
              fa.flash_dq.launches)
    out, lse = fa.flash_fwd(q, k, v, scale, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale, **kw)
    delta = fa.softmax_delta(do, ref_out)
    dk, dv = fa.flash_dkdv(q, k, v, do, ref_lse, delta, scale, **kw)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, scale, **kw)
    assert (fa.flash_fwd.launches, fa.flash_dkdv.launches,
            fa.flash_dq.launches) == tuple(n + 1 for n in before)
    want = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, scale, **kw)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    for got, ref in zip((out, dq, dk, dv), (ref_out,) + want):
        got, ref = got.float(), ref.float()
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
        assert float((got - ref).norm() / ref.norm()) <= rel


def test_flash_kernels_raise_on_what_they_do_not_take(card):
    q = torch.zeros((1, 4, 128, 128), dtype=torch.bfloat16, device=card)
    k = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16, device=card)
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.float(), k.float(), 0.1)
    with pytest.raises(ValueError, match="d in"):
        fa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                     k[..., :32].contiguous(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3), k, k, 0.1)
    with pytest.raises(ValueError, match="kv_valid"):
        fa.flash_fwd(q, k, k, 0.1, kv_valid=129)
    # TMA needs 16-byte aligned tensors: a contiguous view one element in
    misaligned = torch.zeros(q.numel() + 1, dtype=q.dtype,
                             device=card)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(misaligned, k, k, 0.1)
    # 2^31 rows would overflow the 32-bit TMA coordinates (zero strides,
    # no memory behind the shape)
    huge = torch.zeros((1, 1, 1, 64), dtype=q.dtype, device=card)
    with pytest.raises(ValueError, match="2\\^31"):
        fa.flash_fwd(huge.expand(2, 32, 2 ** 25, 64),
                     huge.expand(2, 8, 2 ** 25, 64),
                     huge.expand(2, 8, 2 ** 25, 64), 0.1)
    # the library refuses a design that does not take (dtype, d)
    out, lse = torch.empty_like(q), torch.empty(q.shape[:3], device=card)
    # B, Hq, Hkv, T, S, d, kv_len, q_offset, causal, window, scale
    shape = (1, 4, 2, 128, 128, 128, 128, 0, 1, 0, 0.1)
    stream = torch.cuda.current_stream(card).cuda_stream
    fwd = fa._kernels()[0]
    for is_bf16, design in ((1, 0), (0, 1)):  # bf16 d 128 on FMA, fp32 on wgmma
        assert fwd(q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(),
                   lse.data_ptr(), *shape, is_bf16, design, stream) != 0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape,kw", [
    ((1, 8, 2, 1000, 1000), {}),
    ((2, 4, 2, 256, 456), {"q_offset": 200}),
    ((1, 4, 1, 512, 512), {"window": 100, "kv_valid": 400}),
])
def test_flash_dq_wgmma_matches_plain_on_card(card, d, shape, kw):
    """The dQ kernel on wgmma (bf16, d 64 and 128) against its plain
    version on the plain forward's lse: ragged T, a diagonal inside a tile
    (q_offset 200), a window with kv_valid; chip_smoke.py's bf16 tolerance
    (atol 2e-3, rtol 2e-2, relative norm 5e-3); two calls give equal
    bits."""
    B, Hq, Hkv, T, S = shape
    rng = np.random.RandomState(T + d)
    q, k, v, do = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        torch.bfloat16).to(card) for s in ((B, Hq, T, d), (B, Hkv, S, d),
                                           (B, Hkv, S, d), (B, Hq, T, d)))
    scale = 1.0 / d ** 0.5
    assert fa.kernel_design(q.dtype, d) == "tensor cores"
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, scale, **kw)
    delta = fa.softmax_delta(do, ref_out)
    dq = fa.flash_dq(q, k, v, do, ref_lse, delta, scale, **kw)
    assert torch.equal(dq, fa.flash_dq(q, k, v, do, ref_lse, delta, scale,
                                       **kw))
    want = fa.flash_bwd_plain(q, k, v, do, ref_lse, delta, scale, **kw)[0]
    got, want = dq.float(), want.float()
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)
    assert float((got - want).norm() / want.norm()) <= 5e-3


def test_flash_dq_library_refuses_other_designs_on_card(card):
    """The dQ entry point refuses bf16 d 128 on FMA and fp32 on the tensor
    cores, and launches nothing."""
    q = torch.zeros((1, 4, 128, 128), dtype=torch.bfloat16, device=card)
    k = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16, device=card)
    rows = torch.zeros(q.shape[:3], device=card)
    dq = torch.empty_like(q)
    shape = (1, 4, 2, 128, 128, 128, 128, 0, 1, 0, 0.1)
    stream = torch.cuda.current_stream(card).cuda_stream
    for is_bf16, design in ((1, 0), (0, 1)):
        assert fa._kernels()[2](q.data_ptr(), k.data_ptr(), k.data_ptr(),
                                q.data_ptr(), rows.data_ptr(),
                                rows.data_ptr(), dq.data_ptr(), *shape,
                                is_bf16, design, stream) != 0


def test_fp32_train_step_through_flash_matches_plain_on_card(card):
    """Two fp32 train steps (hd 64, T 256, so ops/auto.py sends attention
    to K2) give the plain attention's loss, grad norm and updated
    trainables (rtol 1e-4, fp32 sums in another order)."""
    from videollm_online_tpu_torch.core.config import LoraConfig
    from videollm_online_tpu_torch.ops.auto import auto_attention
    from videollm_online_tpu_torch.train import optim
    from videollm_online_tpu_torch.train import step as step_mod
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    cfg = LiveTokenizer(ByteTokenizer(), LiveConfig(
        llama=lcfg, lora=LoraConfig(r=8, alpha=16),
        vision_hidden_size=64)).cfg
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 250, (1, 256))
    ids[0, 100:200:3] = cfg.v_placeholder_id
    batch = {"input_ids": torch.from_numpy(ids).to(card),
             "labels": torch.from_numpy(np.roll(ids, -1)).to(card),
             "frames": torch.from_numpy(rng.randn(
                 34, 64).astype(np.float32)).to(card)}
    ocfg = optim.OptimConfig(total_steps=2, warmup_ratio=0.0)
    out = {}
    for name, impl in (("K2", auto_attention), ("plain", llama._attention)):
        gen = torch.Generator(device=card).manual_seed(0)
        state, frozen = step_mod.init_train_state(
            live.init_params(gen, cfg, device=card))
        before = fa.flash_dq.launches
        for _ in range(2):      # step 0 takes lr 0; step 1 moves
            state, m = step_mod.train_step(
                state, frozen, batch, cfg=cfg, optim_cfg=ocfg,
                schedule=optim.make_schedule(ocfg), attn_impl=impl)
        out[name] = (m, state, fa.flash_dq.launches - before)
    (m, state, n), (m_p, state_p, n_p) = out["K2"], out["plain"]
    assert n == 2 * lcfg.num_layers and n_p == 0
    torch.testing.assert_close(m["loss"], m_p["loss"], rtol=1e-4, atol=0)
    torch.testing.assert_close(m["grad_norm"], m_p["grad_norm"], rtol=1e-4,
                               atol=0)
    for a, b in zip(optim.tree_leaves(state.trainable),
                    optim.tree_leaves(state_p.trainable)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def _small_train_setup(card, dtype="float32"):
    from videollm_online_tpu_torch.core.config import LoraConfig
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype=dtype)
    cfg = LiveTokenizer(ByteTokenizer(), LiveConfig(
        llama=lcfg, lora=LoraConfig(r=8, alpha=16, dropout=0.1),
        vision_hidden_size=64)).cfg
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 250, (1, 256))
    ids[0, 100:200:3] = cfg.v_placeholder_id
    batch = {"input_ids": torch.from_numpy(ids).to(card),
             "labels": torch.from_numpy(np.roll(ids, -1)).to(card),
             "frames": torch.from_numpy(rng.randn(
                 34, 64).astype(np.float32)).to(card)}
    return cfg, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_step_offload_equals_plain_step_on_card(card, dtype):
    """Three steps of the in-step offload (moments streamed leaf by leaf
    from pinned host memory on side streams) and of the boundary variant
    equal three plain steps bit for bit: loss, trainables and moments;
    between steps the moments are pinned host tensors."""
    from videollm_online_tpu_torch.train import offload, optim
    from videollm_online_tpu_torch.train import step as step_mod
    cfg, batch = _small_train_setup(card, dtype)
    ocfg = optim.OptimConfig(learning_rate=1e-2, total_steps=6,
                             warmup_ratio=0.2)
    sched = optim.make_schedule(ocfg)
    assert offload.supports_in_step_offload(card)

    def fresh():
        gen = torch.Generator(device=card).manual_seed(0)
        return step_mod.init_train_state(live.init_params(gen, cfg,
                                                          device=card))
    plain, frozen = fresh()
    runs = {}
    for in_step in (True, False):
        state = offload.offload_state(fresh()[0])
        runs[in_step] = (state, offload.make_offload_train_step(
            cfg, ocfg, sched, in_step=in_step, remat_group=2))
    for _ in range(3):
        plain, m = step_mod.train_step(plain, frozen, batch, cfg=cfg,
                                       optim_cfg=ocfg, schedule=sched,
                                       remat_group=2)
        for in_step, (state, step) in list(runs.items()):
            state, mo = step(state, frozen, batch)
            runs[in_step] = (state, step)
            assert torch.equal(mo["loss"], m["loss"]), in_step
            for x in optim.tree_leaves({"m": state.opt_state.mu,
                                        "v": state.opt_state.nu}):
                assert x.device.type == "cpu" and x.is_pinned()
    for state, step in runs.values():
        for a, b in zip(*(optim.tree_leaves(
                {"p": t.trainable, "m": t.opt_state.mu, "v": t.opt_state.nu})
                for t in (plain, state))):
            assert torch.equal(a.detach(), b.detach().to(card))
        n = sum(x.numel() * x.element_size() * 2
                for x in optim.tree_leaves(plain.trainable))
        assert step.moved == {"to_device": 3 * n, "to_host": 3 * n}


def test_tiled_int8_head_on_card(card):
    """The column-tiled int8 head on the card (a ragged last tile) against
    the untiled one: the product and its gradient within a bf16 rounding
    (relative norm), both near the same function on the CPU in fp32."""
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(256, 4000).astype(np.float32))
    qw = {k: v.to(card) for k, v in quant.quantize_weight(w, axis=0).items()}
    x = torch.from_numpy(rng.randn(3, 64, 256).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 64, 4000).astype(np.float32))
    xc, gc = x.to(card).bfloat16(), g.to(card).bfloat16()

    def run(fn):
        xr = xc.clone().requires_grad_(True)
        out = fn(xr)
        (dx,) = torch.autograd.grad(out, xr, gc)
        return out.detach().float().cpu(), dx.float().cpu()
    tiled = run(lambda t: quant.quantized_matmul(t, qw, 1024))
    whole = run(lambda t: quant.quantized_matmul(t, qw))
    qcpu = {k: v.cpu() for k, v in qw.items()}
    xf = xc.float().cpu().requires_grad_(True)
    ref = quant.quantized_matmul(xf, qcpu)
    (dref,) = torch.autograd.grad(ref, xf, gc.float().cpu())
    ref = ref.detach()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    for got, want in ((tiled[0], whole[0]), (tiled[1], whole[1])):
        assert rel(got, want) <= 4e-3
    for got, want in ((tiled[0], ref), (tiled[1], dref)):
        assert rel(got, want) <= 8e-3


# ------------------------------------------------- fused MLP (K4, K5, K6, K7)
# chip_smoke.py's FUSED_TOL: (atol, rtol, relative norm) for MLP outputs in
# bf16 and in fp32 and for K5's fp32 output
FUSED_TOL = {"bf16": (4e-3, 2e-2, 2e-3), "fp32": (1e-3, 1e-3, 1e-4),
             "matmul": (1e-5, 1e-5, 1e-6)}
FUSED = {"q4c": (fm.fused_mlp_int4c, fm.fused_mlp_int4c_reference,
                 quant.quantize_weight_int4c),
         "q4p": (fm.fused_mlp_int4, fm.fused_mlp_int4_reference,
                 quant.quantize_weight_int4),
         "q8": (fm.fused_mlp_int8, fm.fused_mlp_int8_reference,
                lambda w, group=None: quant.quantize_weight(w, axis=-2))}


def _quantized(layout, shapes, group, dev, seed, std=None):
    """Quantized random matrices of the given shapes, of standard deviation
    0.05, or std / sqrt(rows) (a layer's weights, whose outputs keep the
    scale of its inputs) when std is given."""
    rng = np.random.RandomState(seed)
    mats = []
    for shape in shapes:
        scale = 0.05 if std is None else std / shape[0] ** 0.5
        q = FUSED[layout][2](torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(dev),
            group=group)
        mats += [q[layout], q["scale"]]
    return mats, rng


def _held(got, want, tol):
    atol, rtol, rel = FUSED_TOL[tol]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) <= rel


@pytest.mark.parametrize("layout,D,F,group", [
    ("q4c", 64, 128, 128), ("q4c", 192, 320, 64), ("q4c", 48, 80, 16),
    ("q4p", 128, 192, 64), ("q4p", 384, 256, 128), ("q8", 80, 176, 0)])
@pytest.mark.parametrize("rows,dtype", [(1, "bfloat16"), (20, "float32"),
                                        (40, "bfloat16"), (91, "bfloat16"),
                                        (128, "float32")])
def test_fused_mlp_kernels_match_plain_on_card(card, layout, D, F, group,
                                               rows, dtype):
    """K4, K7 and K6 against their plain versions on real quantized weights:
    every row configuration, groups below 128, byte rows that are not a
    multiple of 16 or of the column tile, an odd number of groups; one launch
    counted per call; two runs of one input give equal bits."""
    kern, plain, _ = FUSED[layout]
    mats, rng = _quantized(layout, [(D, F), (D, F), (F, D)], group, card,
                           D + F + rows)
    x = torch.from_numpy(4 * rng.randn(rows, D).astype(np.float32)).to(
        getattr(torch, dtype)).to(card)
    before = kern.launches
    got = kern(x, *mats)
    assert kern.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, kern(x, *mats))
    _held(got, plain(x, *mats), "bf16" if dtype == "bfloat16" else "fp32")


@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("rows", [1, 3, 7, 17, 33, 91, 128])
def test_fused_mlp_q4c_wgmma_matches_plain_on_card(card, rows, group):
    """K4's wgmma kernel (D and F multiples of 32) against its plain
    version at every N it instantiates (8, 16 .. 128 rows of x), groups of
    64 and 128, byte columns that are not a multiple of the column tile
    (F / 2 = 320 and D / 2 = 192 against tiles of 64 to 256), bf16 x of
    unit scale, as a normed hidden state and as chip_smoke.py's 8B cases;
    chip_smoke.py's bf16 tolerance; two calls give equal bits. (At 4 times
    that scale h reaches about 170 at this D, where one bf16 ulp is 1: the
    fp32 sums taken in another order than the plain version's flip an h
    rounding now and then, which moves outputs by up to 0.06, past the
    absolute tolerance.)"""
    D, F = 384, 640
    assert D % fm.Q4C_ALIGN == 0 and F % fm.Q4C_ALIGN == 0
    mats, rng = _quantized("q4c", [(D, F), (D, F), (F, D)], group, card,
                           rows + group)
    x = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).to(
        torch.bfloat16).to(card)
    before = fm.fused_mlp_int4c.launches
    got = fm.fused_mlp_int4c(x, *mats)
    assert fm.fused_mlp_int4c.launches == before + 1
    assert torch.equal(got, fm.fused_mlp_int4c(x, *mats))
    _held(got, fm.fused_mlp_int4c_reference(x, *mats), "bf16")


@pytest.mark.parametrize("rows,K,N,group", [(1, 64, 512, 128),
                                            (33, 128, 1000, 64),
                                            (128, 256, 2048, 128)])
def test_matmul_int4c_kernel_matches_plain_on_card(card, rows, K, N, group):
    (w, s), rng = _quantized("q4c", [(K, N)], group, card, K + N)
    x = torch.from_numpy(rng.randn(rows, K).astype(np.float32)).to(
        torch.bfloat16).to(card)
    before = fm.matmul_int4c.launches
    got = fm.matmul_int4c(x, w, s)
    assert fm.matmul_int4c.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (rows, N)
    _held(got, fm.matmul_int4c_reference(x, w, s), "matmul")
    # every byte value decodes right: random bytes against the plain version
    wr = torch.randint(-128, 128, w.shape, dtype=torch.int8, device=card)
    _held(fm.matmul_int4c(x, wr, s), fm.matmul_int4c_reference(x, wr, s),
          "matmul")


def test_fused_kernels_raise_on_what_they_do_not_take(card):
    mats, _ = _quantized("q4c", [(64, 128), (64, 128), (128, 64)], 128, card,
                         0)
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="rows"):
        fm.fused_mlp_int4c(torch.zeros((129, 64), dtype=torch.bfloat16,
                                       device=card), *mats)
    with pytest.raises(ValueError, match="CUDA device"):
        fm.fused_mlp_int4c(x, mats[0].cpu(), *mats[1:])
    with pytest.raises(TypeError):
        fm.fused_mlp_int4c(x, mats[0], mats[1].double(), *mats[2:])
    with pytest.raises(RuntimeError, match="no backward"):
        fm.fused_mlp_int4c(x.clone().requires_grad_(True), *mats)
    odd, _ = _quantized("q4c", [(24, 32)], 8, card, 1)     # groups of 8 rows
    with pytest.raises(ValueError, match="multiple of 16"):
        fm.matmul_int4c(torch.zeros((1, 24), dtype=torch.bfloat16,
                                    device=card), *odd)


# ------------------------------- the streaming core of K5 and K6 (wo_kernel)
@pytest.mark.parametrize("rows", [1, 8, 20, 91, 128])
@pytest.mark.parametrize("K,N,group", [(512, 128256, 128), (512, 128256, 64),
                                       (256, 2080, 128), (256, 2080, 64),
                                       (80, 1024, 16)])
def test_matmul_int4c_streaming_core_matches_plain_on_card(card, rows, K, N,
                                                           group):
    """K5 on the streaming core against its plain version: the 8B vocab (V
    128256, 501 strips of 128 byte columns) and N 2080 (a strip tail of 16
    byte columns), groups of 64 and 128, and groups of 16 over K 80 (four
    groups a slot, a last slot of 16 rows), at every N it instantiates
    (8 to 64, two 64-row blocks at 91 and 128 rows); chip_smoke.py's K5
    tolerance; the wrapper launches one call and two calls give equal
    bits."""
    (w, s), rng = _quantized("q4c", [(K, N)], group, card, K + N + rows)
    x = torch.from_numpy(rng.randn(rows, K).astype(np.float32)).to(
        torch.bfloat16).to(card)
    want = fm.matmul_int4c_reference(x, w, s)
    got = fm._launch_matmul(x, w, s, True)
    assert got.dtype == torch.float32 and got.shape == (rows, N)
    _held(got, want, "matmul")
    assert torch.equal(got, fm._launch_matmul(x, w, s, True))
    before = fm.matmul_int4c.launches
    _held(fm.matmul_int4c(x, w, s), want, "matmul")
    assert fm.matmul_int4c.launches == before + 1


@pytest.mark.parametrize("rows", [1, 20, 91, 128])
@pytest.mark.parametrize("D,F", [(4096, 14336), (80, 176)])
def test_fused_mlp_int8_streaming_core_matches_plain_on_card(card, rows, D,
                                                             F):
    """K6 on the streaming core against its plain version at the 8B shapes
    and at D 80, F 176 (strips of 80 and 48 byte columns, a last slot of 16
    rows), bf16 x of unit scale and weights of a layer's scale (outputs of
    about 0.5, as chip_smoke.py's 8B cases; with weights of 0.05 at D 4096
    the outputs reach about 30, where a bf16 rounding flip of h that an
    fp32 sum in another order causes moves an output past the absolute
    tolerance, for the plain version as for any kernel); chip_smoke.py's
    bf16 tolerance; the wrapper launches one call and two calls give equal
    bits."""
    mats, rng = _quantized("q8", [(D, F), (D, F), (F, D)], 0, card,
                           D + F + rows, std=1.0)
    x = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).to(
        torch.bfloat16).to(card)
    want = fm.fused_mlp_int8_reference(x, *mats)
    got = fm._launch_wo_mlp(fm.LAYOUT_Q8, x, *mats)
    assert got.dtype == x.dtype and got.shape == x.shape
    _held(got, want, "bf16")
    assert torch.equal(got, fm._launch_wo_mlp(fm.LAYOUT_Q8, x, *mats))
    before = fm.fused_mlp_int8.launches
    _held(fm.fused_mlp_int8(x, *mats), want, "bf16")
    assert fm.fused_mlp_int8.launches == before + 1


def test_fused_mlp_int8_streaming_core_is_exact_on_card(card):
    """K6 on the streaming core with weights that hold every int8 value,
    unit gate and up scales and one-hot x rows gives exact integers: x row
    i selects reduction row k, the gate there is 32 on the diagonal (silu
    is then 32 exactly in fp32), the up matrix holds the 256 values on its
    diagonal and zeros elsewhere, so h is 32 v_k at f = k and 0 elsewhere,
    and out[i, d] = 32 v_k wd[k, d] (at most 2^19, exact in fp32)."""
    n = 256
    idx = torch.arange(n, device=card)
    val = (idx - 128).to(torch.int8)                    # every int8 value
    wg = (((idx[:, None] + idx[None, :]) % n) - 128).to(torch.int8)
    wg[idx, idx] = 32
    wu = torch.zeros((n, n), dtype=torch.int8, device=card)
    wu[idx, idx] = val
    wd = (((idx[:, None] + 3 * idx[None, :]) % n) - 128).to(torch.int8)
    ones = torch.ones(n, device=card)
    for ks in (list(range(128)), list(range(128, 256)), [255]):
        x = torch.zeros((len(ks), n), device=card)
        x[torch.arange(len(ks)), torch.tensor(ks)] = 1.0
        got = fm._launch_wo_mlp(fm.LAYOUT_Q8, x, wg, ones, wu, ones, wd, ones)
        k = torch.tensor(ks, device=card)
        want = 32.0 * val[k].float()[:, None] * wd[k].float()
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows", [1, 7, 8, 20, 24, 64, 91, 128])
@pytest.mark.parametrize("D,F,group", [(512, 1024, 32), (512, 1024, 64),
                                       (512, 1024, 128), (512, 1024, 256),
                                       (320, 1088, 32)])
def test_fused_mlp_int4_streaming_core_matches_plain_on_card(card, rows, D,
                                                             F, group):
    """K7 on the streaming core against its plain version: groups of 32
    (two a slot), 64, 128 and 256 (two slots a group), at every N the core
    instantiates (8, 24, 64-row blocks; 7, 8, 20, 24 and 64 rows fill a
    design or fall one short), splits of the reduction (more than one at
    1 row for every group below 256, K7's schedule at 132 SMs), and D 320,
    F 1088 (strips of 64 byte columns past the last whole one, a last slot
    of 32 byte rows); bf16 x of unit scale and weights of a layer's scale;
    chip_smoke.py's bf16 tolerance; the wrapper takes the core, launches
    one call and two calls give equal bits."""
    mats, rng = _quantized("q4p", [(D, F), (D, F), (F, D)], group, card,
                           D + F + rows + group, std=1.0)
    pairs = (mats[0:2], mats[2:4], mats[4:6])
    assert fm._wo_takes(fm.LAYOUT_Q4P, pairs)
    if rows == 1 and group < 256:
        sms = fm._sm_count(card)
        assert fm.wo_schedule(fm.LAYOUT_Q4P, D // 2, F, 1, group, 2,
                              sms)[1] > 1
    x = torch.from_numpy(rng.randn(rows, D).astype(np.float32)).to(
        torch.bfloat16).to(card)
    want = fm.fused_mlp_int4_reference(x, *mats)
    got = fm._launch_wo_mlp(fm.LAYOUT_Q4P, x, *mats)
    assert got.dtype == x.dtype and got.shape == x.shape
    _held(got, want, "bf16")
    assert torch.equal(got, fm._launch_wo_mlp(fm.LAYOUT_Q4P, x, *mats))
    before = fm.fused_mlp_int4.launches
    assert torch.equal(fm.fused_mlp_int4(x, *mats), got)
    assert fm.fused_mlp_int4.launches == before + 1


def test_fused_mlp_int4_streaming_core_is_exact_on_card(card):
    """K7 on the streaming core with q4p weights that hold every nibble
    value in both halves of the reduction, scales 8 (gate) and 1 and
    one-hot x rows gives exact integers: x row i selects reduction row k
    (low nibbles for k < 128, high for k >= 128), the gate there is 7 * 8
    = 56 on the diagonal (silu(56) is 56 in fp32), the up matrix holds
    v_k = k % 16 - 8 on its diagonal and zeros elsewhere, so h is 56 v_k
    at f = k (exact in bf16) and 0 elsewhere, and out[i, d] = 56 v_k
    wd[k, d] (at most 3584 in magnitude, exact in fp32)."""
    n = 256
    idx = torch.arange(n, device=card)
    q_g = ((idx[:, None] + idx[None, :]) % 16 - 8).to(torch.int8)
    q_g[idx, idx] = 7
    q_u = torch.zeros((n, n), dtype=torch.int8, device=card)
    q_u[idx, idx] = (idx % 16 - 8).to(torch.int8)
    q_d = ((idx[:, None] + 3 * idx[None, :]) % 16 - 8).to(torch.int8)
    wg, wu, wd = (quant._pack_nibbles(q) for q in (q_g, q_u, q_d))
    ones = torch.ones((2, n), device=card)
    mats = (wg, 8 * ones, wu, ones, wd, ones)
    assert fm._wo_takes(fm.LAYOUT_Q4P, (mats[0:2], mats[2:4], mats[4:6]))
    for ks in (list(range(128)), list(range(128, 256)), [255]):
        x = torch.zeros((len(ks), n), device=card)
        x[torch.arange(len(ks)), torch.tensor(ks)] = 1.0
        got = fm._launch_wo_mlp(fm.LAYOUT_Q4P, x, *mats)
        k = torch.tensor(ks, device=card)
        want = 56.0 * q_u[k, k].float()[:, None] * q_d[k].float()
        assert torch.equal(got, want)


def test_streaming_core_refuses_other_layouts_and_designs_on_card(card):
    """The streaming core's entry points refuse another layout than
    their own (K5's q4c: q4p, an unknown code, int8; the MLP's int8 and
    q4p: q4c, an unknown code), a design (N) that is not 8, 16, 32 or 64
    (or 24 for int4) or serves fewer rows than x has, out as the workspace
    at more than one split, and q4p shapes the core does not take (half
    the reduction dim not a multiple of the group, or of 16; a group that
    neither divides a slot nor is a multiple of one); they launch nothing
    then, and K7's streaming route raises on such a shape."""
    (w, s), _ = _quantized("q4c", [(256, 2048)], 128, card, 3)
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=card)
    out = torch.zeros((4, 2048), device=card)
    part = torch.zeros((2 * 4 * 2048,), device=card)
    stream = torch.cuda.current_stream(card).cuda_stream
    mm, mlp = fm._kernels()[3], fm._kernels()[4]
    for layout, design, splits, per, ws in ((1, 8, 1, 256, part),
                                            (5, 8, 1, 256, part),
                                            (0, 40, 1, 256, part),
                                            (2, 24, 1, 256, part),
                                            (0, 4, 1, 256, part),
                                            (0, 2, 1, 256, part),
                                            (0, 8, 2, 128, out)):
        assert mm(layout, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                  ws.data_ptr(), out.data_ptr(), 4, 256, 2048, 128, splits,
                  per, 4, design, stream) != 0
    h = torch.zeros((4, 2048), dtype=torch.bfloat16, device=card)
    # (layout, D, group, design): q4c and an unknown code; q4p with D / 2 =
    # 128 not a multiple of the group 256, D / 2 = 120 not a multiple of
    # 16, a group of 48 (neither dividing a slot of 64 rows nor a multiple
    # of one), design 40 (no instance) and design 2 (fewer rows than x's 4)
    for layout, D, group, design in ((0, 256, 128, 8), (5, 256, 128, 8),
                                     (1, 256, 256, 8), (1, 240, 16, 8),
                                     (1, 192, 48, 8), (1, 256, 128, 40),
                                     (1, 256, 128, 2)):
        assert mlp(layout, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                   w.data_ptr(), s.data_ptr(), w.data_ptr(), s.data_ptr(),
                   h.data_ptr(), part.data_ptr(), out.data_ptr(), 4, D,
                   2048, group, 128, 1, 256, 4, 1, 2048, 4, design,
                   stream) != 0
    torch.cuda.synchronize()
    assert not out.any()
    # K7's streaming route called on a shape the core does not take raises
    # (the wrapper itself takes the mma.sync family there, a shape rule)
    mats, rng = _quantized("q4p", [(384, 256), (384, 256), (256, 384)], 128,
                           card, 4)
    assert not fm._wo_takes(fm.LAYOUT_Q4P, (mats[0:2], mats[2:4],
                                            mats[4:6]))
    xq = torch.from_numpy(rng.randn(4, 384).astype(np.float32)).to(
        torch.bfloat16).to(card)
    with pytest.raises(RuntimeError, match="fused_mlp_wo_swiglu"):
        fm._launch_wo_mlp(fm.LAYOUT_Q4P, xq, *mats)
    before = fm.fused_mlp_int4.launches
    _held(fm.fused_mlp_int4(xq, *mats), fm.fused_mlp_int4_reference(xq, *mats),
          "bf16")
    assert fm.fused_mlp_int4.launches == before + 1


def test_int4_forward_dispatches_the_kernels_on_card(card, monkeypatch):
    """A small mixed-int4 decoder on the card: every layer's MLP goes to K4
    and the head to K5; with VLO_FUSED_MLP=0 none does and the logits agree
    (the dequantizing route rounds the scaled weights, not the activations,
    to the model's dtype: fp32 here, so the two differ by the kernels' bf16
    rounding of x and h, about 2^-9 of a value: atol 3e-2 on logits of
    magnitude about 1)."""
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    gen = torch.Generator(device=card).manual_seed(0)
    params = quant.quantize_llama_params(
        llama.init_params(gen, lcfg, device=card), bits=4)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (1, 20)))
    before = fm.fused_mlp_int4c.launches, fm.matmul_int4c.launches
    got, _ = llama.forward(params, cfg=lcfg, input_ids=ids)
    assert (fm.fused_mlp_int4c.launches, fm.matmul_int4c.launches) == (
        before[0] + 2, before[1] + 1)
    monkeypatch.setenv("VLO_FUSED_MLP", "0")
    want, _ = llama.forward(params, cfg=lcfg, input_ids=ids)
    assert (fm.fused_mlp_int4c.launches, fm.matmul_int4c.launches) == (
        before[0] + 2, before[1] + 1)
    torch.testing.assert_close(got, want, atol=3e-2, rtol=0)
    assert got.dtype == torch.float32


# --------------------------------------------------------------------- K3
def _paged_inputs(S, dtype, dev, d=64, page=64, seed=8,
                  starts=(250, 3, 130)):
    """Three streams of 512 slots under a shuffled table; stream 1's last
    table entry is the trash page 0, past anything it sees."""
    rng = np.random.RandomState(seed)
    maxp = 512 // page
    Bp, P = len(starts), 1 + len(starts) * maxp
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = torch.from_numpy(rng.randn(Bp, HKV * G, S, d).astype(np.float32))
    shape = (L, P, HKV, page, d)
    if dtype == "int8":
        k, v = (torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
                for _ in range(2))
        sc = {n: torch.from_numpy((rng.rand(*shape[:-1]) / 64).astype(
            np.float32)).to(dev) for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(qdt)
                for _ in range(2))
        sc = {}
    table = (rng.permutation(P - 1)[:Bp * maxp] + 1).reshape(Bp, maxp)
    table[1, -1] = 0
    q_pos = np.stack([s + np.arange(S) for s in starts]).astype(np.int32)
    return (q.to(qdt).to(dev), k.to(dev), v.to(dev),
            torch.from_numpy(table.astype(np.int32)).to(dev),
            torch.from_numpy(q_pos).to(dev), sc)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
@pytest.mark.parametrize("d,page", [(64, 64), (128, 32), (256, 64),
                                    (64, 32), (128, 128)])
def test_paged_kernel_matches_plain_on_card(card, dtype, d, page):
    """Tolerance, elementwise and on the relative norm error, chip_smoke.py's
    K3_TOL, set from its readings: bf16 queries (bf16 or int8 pools) atol
    4e-3 and rtol 2e-2, relative norm 5e-3; fp32 atol 1e-6, rtol 1e-5,
    relative norm 1e-6. The trash page, which no query may read, holds
    NaN."""
    atol, rtol, rel = ((1e-6, 1e-5, 1e-6) if dtype == "float32"
                       else (4e-3, 2e-2, 5e-3))
    # rows (G * S) not a multiple of 16 at S 7 and 21; window edges and
    # first visible slots inside a 64-slot tile; pages of 32 under 64-slot
    # tiles and of 128 (one page-table lookup a tile)
    for S, window in ((1, None), (20, 100), (91, None), (128, 50), (7, None),
                      (21, 77)):
        q, k, v, table, q_pos, sc = _paged_inputs(S, dtype, card, d, page)
        want = pa.paged_attention_reference(q, k, v, table, q_pos, LAYER,
                                            window=window, **sc)
        if dtype == "int8":
            sc["k_scale"][LAYER, 0] = float("nan")
        else:
            k[LAYER, 0] = float("nan")
        before = pa.paged_decode_attention.launches
        got = pa.paged_attention(q, k, v, table, q_pos, LAYER,
                                 window=window, **sc)
        assert pa.paged_decode_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        assert float((got.float() - want.float()).norm()
                     / want.float().norm()) <= rel


def test_paged_kernel_empty_rows_and_refusals_on_card(card):
    q, k, v, table, q_pos, _ = _paged_inputs(3, "float32", card)
    q_pos[0, 0] = -1                       # a row that sees nothing
    got = pa.paged_decode_attention(q, k, v, table, q_pos, 0)
    assert torch.count_nonzero(got[0, :, 0]) == 0
    torch.testing.assert_close(got, pa.paged_attention_reference(
        q, k, v, table, q_pos, 0), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, k, v, table.long(), q_pos, 0)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, k, v, table, q_pos, L)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q, k.to(torch.bfloat16),
                                  v.to(torch.bfloat16), table, q_pos, 0)
    # d outside the kernel's sizes raises on the card, through the dispatch
    # too: nothing falls back to the plain version there
    q48 = q[..., :48].contiguous()
    k48, v48 = k[..., :48].contiguous(), v[..., :48].contiguous()
    before = pa.paged_decode_attention.launches
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q48, k48, v48, table, q_pos, 0)
    with pytest.raises(ValueError):
        pa.paged_attention(q48, k48, v48, table, q_pos, 0)
    assert pa.paged_decode_attention.launches == before


def test_multistream_paged_through_k3_equals_plain_on_card(card,
                                                            monkeypatch):
    """A small fp32 paged MultiStreamEngine: every paged forward launches K3
    once a layer, and the transcripts equal those through the plain
    version."""
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype="float32")
    cfg = LiveConfig(llama=lcfg, lora=None, vision_hidden_size=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(max_response_tokens=12)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = {"llama": llama.init_params(gen, cfg.llama, device="cuda"),
              "connector": live.init_connector(gen, cfg, device="cuda")}
    feats = np.random.RandomState(1).randn(
        12, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)

    def run():
        ms = MultiStreamEngine(params, tok, cfg, num_streams=2,
                               kv_capacity=1024, page_size=64, paged=True,
                               device="cuda")
        for i in range(2):
            ms.input_frames(i, 0.0, feats)
            ms.input_query(i, "what now?", 2.0)
        while ms.pending():
            ms.step()
        return ms.transcripts

    pa.paged_decode_attention.launches = 0
    got = run()
    assert pa.paged_decode_attention.launches > 0
    assert pa.paged_decode_attention.launches % lcfg.num_layers == 0
    monkeypatch.setattr(pa, "paged_attention", pa.paged_attention_reference)
    assert run() == got


@pytest.mark.parametrize("dtype,kv_quant", [("float32", None),
                                            ("bfloat16", None),
                                            ("bfloat16", "int8")])
def test_multistream_decode_graph_equals_eager_on_card(card, monkeypatch,
                                                       dtype, kv_quant):
    """The greedy decode forward replayed as one CUDA graph: a small paged
    MultiStreamEngine (pages of 16, so answers cross into new pages
    mid-decode; streams answering alone and together, a tick a frame)
    gives the eager forward's transcripts byte for byte, captures once and
    replays every later decode forward, and after ``reset()`` captures
    again and still equals the eager run. K3's launch counter sees the
    capture (its warm-up and the capture itself) and no replay."""
    lcfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                       num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                       dtype=dtype)
    cfg = LiveConfig(llama=lcfg, lora=None, vision_hidden_size=64)
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg.replace(max_response_tokens=12, gate_logit_bias=60.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    # weights at 4x init_params' scale, so the greedy answers vary token by
    # token (at 0.02 every answer repeats one byte)
    p = llama.init_params(gen, cfg.llama, device="cuda")
    p = {k: v * 4 if k in ("embed", "lm_head") else v for k, v in p.items()}
    p["layers"] = {k: v * 4 if k.startswith("w") else v
                   for k, v in p["layers"].items()}
    params = {"llama": p, "connector": live.init_connector(gen, cfg,
                                                           device="cuda")}
    feats = np.random.RandomState(1).randn(
        12, cfg.frame_num_tokens, cfg.vision_hidden_size).astype(np.float32)
    page = 16
    forward = llama.forward
    calls = [0]           # every forward
    decode_rows = []      # per graph-mode forward: (offsets, rows fed)

    def spy(params, **kw):
        calls[0] += 1
        if kw.get("decode_graph") is not None:
            decode_rows.append((kw["kv_cache"].offset.numpy().copy(),
                                np.asarray(kw["num_valid"]).copy()))
        return forward(params, **kw)

    monkeypatch.setattr(llama, "forward", spy)

    def drive(ms):
        for i in range(3):
            ms.input_frames(i, 0.0, feats)
            for t in ((0.5, 3.0, 5.0), (1.0, 3.0), (2.0, 4.0, 5.5))[i]:
                ms.input_query(i, f"what now {i}?", t)
        while ms.pending():
            ms.step()
        return [list(t) for t in ms.transcripts]

    def engine():
        return MultiStreamEngine(params, tok, cfg, num_streams=3,
                                 kv_capacity=1024, page_size=page, paged=True,
                                 chunk_frames=1, kv_quant=kv_quant,
                                 device="cuda")

    ms = engine()
    pa.paged_decode_attention.launches = 0
    got = drive(ms)
    c = ms.counters()
    assert c["decode_graph_captures"] == 1
    assert (c["decode_graph_captures"] + c["decode_graph_replays"]
            == c["decode_forwards"] == len(decode_rows))
    assert c["decode_rows_valid"] < c["decode_rows"]
    # a live row appends at the first slot of a page
    assert any(((off % page == 0) & (nv > 0)).any()
               for off, nv in decode_rows)
    # every forward but the replays launched K3 once a layer, the capture
    # twice (warm-up and capture)
    launching = (calls[0] + c["decode_graph_captures"]
                 - c["decode_graph_replays"])
    assert pa.paged_decode_attention.launches == lcfg.num_layers * launching
    ms.reset()
    again = drive(ms)
    assert ms.counters()["decode_graph_captures"] == 1

    monkeypatch.setattr(MultiStreamEngine, "_decode_graph", lambda self: None)
    eager = engine()
    want = drive(eager)
    assert eager.counters()["decode_graph_captures"] == 0
    assert got == want and again == want
    assert len({a for t in want for _, a in t}) > 4


# ----------------------------------------------- the demo path's options
def _chip_smoke():
    """chip_smoke.py at the repository's root, as a module."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_engine_options_kernel_equal_plain_on_card(card):
    """Raw uint8 frames through a small fp32 SigLIP tower, the int8 KV ring
    compacted to a stream_window, 4-token segments and spec decode, all at
    once (chip_smoke.py's small demo engine, a frame every tick): the same
    transcripts and on_delta segments through K1 (its int8 form) as
    through the plain attention, with K1 launched on the compacted
    ring."""
    cs = _chip_smoke()
    setup = cs.small_demo_setup(card)
    frames = np.random.RandomState(0).randint(0, 256, (32, 3, 64, 64)
                                              ).astype(np.uint8)
    da.ring_decode_attention_layered.launches = 0
    got, got_deltas, eng, at_compaction = cs.small_demo_drive(
        setup, frames, video_every=1, device=card)
    assert eng.cache.k.dtype == torch.int8 and at_compaction is not None
    assert da.ring_decode_attention_layered.launches > at_compaction
    plain, plain_deltas, _, _ = cs.small_demo_drive(
        setup, frames, video_every=1, device=card, attn_impl=llama._attention)
    assert got == plain and got_deltas == plain_deltas and got


def test_vision_tower_bf16_near_fp32_on_card(card):
    """SigLIP at the large tower's widths (D 1024, F 4096, 16 heads) and 2
    layers: bf16 frame features within a relative norm of 1e-2 of the same
    weights in fp32, about three times the readings on an H100 (3.14e-3 to
    3.21e-3 over 16 draws of 4 frames of these weights); chip_smoke.py's
    DEMO_ENC_REL holds the 24-layer tower at the same bound."""
    from videollm_online_tpu_torch.core.config import (VisionConfig,
                                                       live1_plus_config)
    from videollm_online_tpu_torch.models import siglip
    vcfg = VisionConfig(num_layers=2, dtype="bfloat16")
    cfg = live1_plus_config(vision=vcfg)
    p16 = siglip.init_params(torch.Generator(device=card).manual_seed(0),
                             vcfg, device=card)

    def f32(t):
        return ({k: f32(v) for k, v in t.items()} if isinstance(t, dict)
                else t.float())

    px = torch.randint(0, 256, (4, 3, 384, 384), dtype=torch.uint8,
                       device=card)
    x = siglip.preprocess(px, vcfg)
    got = siglip.frame_features(p16, x, vcfg, cfg)
    want = siglip.frame_features(f32(p16), x, vcfg, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 10, 1024)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel < 1e-2, rel


@pytest.mark.parametrize("S,window,q_dtype,d", [
    (1, None, torch.bfloat16, 128), (4, None, torch.bfloat16, 128),
    (14, None, torch.bfloat16, 128), (1, 128, torch.float32, 64),
    (4, 128, torch.float32, 64), (14, 128, torch.float32, 64)])
def test_k1_int8_ring_shapes_of_the_demo_on_card(card, S, window, q_dtype,
                                                   d):
    """K1's int8 form at the shapes the demo path gives it: the 8B
    --kv_quant int8 ring (Hq 32, Hkv 8, d 128, a ring of 16384, bf16
    queries; S 1 decode, 4 a 4-token segment's verify step, 14 a frame
    step) and the small engine's compacted window (fp32 queries, d 64,
    window 128 on a ring of 640), against the plain version at K1_TOL."""
    Hq, Hkv, C = (32, 8, 16384) if d == 128 else (8, 2, 640)
    rng = np.random.RandomState(S)
    L = 2
    k, v = (torch.from_numpy(rng.randint(-127, 128, (L, 1, Hkv, C, d)
                                         ).astype(np.int8)).to(card)
            for _ in range(2))
    sc = {n: torch.from_numpy((rng.rand(L, 1, Hkv, C) / 64).astype(
        np.float32)).to(card) for n in ("k_scale", "v_scale")}
    q = torch.from_numpy(rng.randn(1, Hq, S, d).astype(np.float32)).to(
        q_dtype).to(card)
    start = 3000 if d == 128 else 500
    q_pos = torch.arange(start, start + S, dtype=torch.int32,
                         device=card)[None]
    got = da.ring_decode_attention_layered(q, k, v, q_pos, 1, window=window,
                                           **sc)
    want = da.ring_decode_attention_layered_reference(q, k, v, q_pos, 1,
                                                      window=window, **sc)
    atol, rtol = ((1e-6, 1e-5) if q_dtype == torch.float32
                  else (2e-3, 2e-2))
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def test_eval_prefill_route_matches_plain_on_card(card):
    """StreamEvaluator's whole-video prefill at T = 8192 (8B heads, bf16):
    ``_prefill_attn`` slices a longer ring to its first T slots and launches
    K2f once; the output equals K2f's plain version over the slice, chunk
    by chunk of queries, at chip_smoke.py's K2_TOL for bf16 (atol 2e-3,
    rtol 2e-2, relative norm 5e-3)."""
    from videollm_online_tpu_torch.eval import stream_evaluate as se
    g = torch.Generator(device=card).manual_seed(0)
    T, C, Hq, Hkv, d = 8192, 8192 + 300, 32, 8, 128
    q = torch.randn(1, Hq, T, d, generator=g, device=card).bfloat16()
    k = torch.randn(1, Hkv, C, d, generator=g, device=card).bfloat16()
    v = torch.randn(1, Hkv, C, d, generator=g, device=card).bfloat16()
    k[:, :, T:] = v[:, :, T:] = float("nan")   # no query may read past T
    before = fa.flash_fwd.launches
    got = se._prefill_attn(q, k, v, torch.arange(T, device=card)[None], None,
                           num_groups=Hq // Hkv)
    assert fa.flash_fwd.launches == before + 1
    errs = []
    for r in range(0, T, 2048):
        want, _ = fa.flash_attention_fwd_reference(
            q[:, :, r:r + 2048], k[:, :, :T], v[:, :, :T], d ** -0.5, True,
            r)
        torch.testing.assert_close(got[:, :, r:r + 2048].float(),
                                   want.float(), atol=2e-3, rtol=2e-2)
        errs.append(float((got[:, :, r:r + 2048].float() - want.float())
                          .norm() / want.float().norm()))
    assert max(errs) <= 5e-3, errs


def test_tiny_evaluators_kernel_equal_plain_on_card(card):
    """A small fp32 model (d 64, so the prefill takes K2f and decode K1):
    StreamEvaluator through K2f and through the plain attention gives the
    same frame_diff, fluency and LM-correctness and lm_ppl within 1e-5;
    the beam search and greedy decode through K1 and through the plain
    attention return the same ids."""
    from videollm_online_tpu_torch.data.collator import collate
    from videollm_online_tpu_torch.eval import generation
    from videollm_online_tpu_torch.eval.stream_evaluate import (
        StreamEvaluator)
    from videollm_online_tpu_torch.core.config import tiny_live_config
    cfg = tiny_live_config(llama=LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
        dtype="float32"))
    tok = LiveTokenizer(ByteTokenizer(), cfg)
    cfg = tok.cfg
    params = live.init_params(torch.Generator(device=card).manual_seed(0),
                              cfg, device=card)
    conv = [{"role": "system", "content": "sys."}]
    for i, nf in enumerate([3, 5, 2, 4]):
        conv += [{"role": "stream", "num_frames": nf, "learn": True},
                 {"role": "assistant", "content": f"event {i} happens.",
                  "learn": True}]
    frames = np.random.RandomState(0).randn(14, cfg.frame_num_tokens,
                                            cfg.vision_hidden_size)
    batch = collate([(tok.apply_chat_template(conv),
                      frames.astype(np.float32), tok.get_learn_ranges(conv),
                      0, None)], tokenizer=tok)
    before = fa.flash_fwd.launches
    got = StreamEvaluator(params, cfg)(batch["input_ids"], batch["labels"],
                                       batch["frames"], 0.5)
    assert fa.flash_fwd.launches == before + cfg.llama.num_layers
    want = StreamEvaluator(params, cfg, attn_impl=llama._attention)(
        batch["input_ids"], batch["labels"], batch["frames"], 0.5)
    np.testing.assert_array_equal(got[1:], want[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)

    ids = batch["input_ids"][:, :200]
    kw = dict(max_new_tokens=24, num_return_sequences=3)
    before = da.ring_decode_attention_layered.launches
    beams = generation.BeamSearcher(params, cfg, 3).search(
        ids, batch["frames"], **kw)
    assert da.ring_decode_attention_layered.launches > before
    plain = generation.BeamSearcher(params, cfg, 3,
                                    attn_impl=llama._attention).search(
        ids, batch["frames"], **kw)
    for a, b in zip(beams, plain):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        generation.greedy_from_embeds(params, cfg, ids, batch["frames"],
                                      max_new_tokens=24),
        generation.greedy_from_embeds(params, cfg, ids, batch["frames"],
                                      max_new_tokens=24,
                                      attn_impl=llama._attention))


def test_tp2_forward_on_two_ranks_of_the_card(card, tmp_path):
    """Two ranks on the one card (gloo, the collectives through pinned host
    buffers: parallel/mesh.py's rule) run a tensor-parallel forward of a
    small bf16 decoder with params cut ``tp`` over model=2; K1 runs on
    both ranks at their 4 q / 1 kv heads, and the logits hold to the
    unsharded forward within a relative norm of 2e-2 (bf16: each
    row-parallel product is two rounded partial sums added, where one
    rank rounds one fp32 sum)."""
    import _torch_parallel_workers as workers
    from _torch_dist import run_world
    for rank, r in enumerate(run_world(workers.tp_forward_cuda, 2,
                                       tmp_path)):
        assert r["staging"] and r["k1"] == 2, (rank, r)
        assert r["rel"] < 2e-2, (rank, r)
