"""The int4 serving slice of the port against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in the port: the int4 quantizers (bytes and scales bit
for bit), the plain PyTorch versions of the fused-MLP kernels K4, K5, K6
and K7 against the Pallas kernels run in interpret mode, the dequantizing
``quantized_matmul``, the dispatch table, ``llama.forward`` and one layer on
the mixed int4 layout, and the port's ``serve/cli.py``. The engine's int4
transcripts are held in tests/test_torch_engine.py.
"""

import argparse
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_live
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.models import quant as jax_quant
from videollm_online_tpu.ops import fused_mlp as jax_fused

from videollm_online_tpu_torch.core.config import LlamaConfig, tiny_live_config
from videollm_online_tpu_torch.models import llama, quant
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.ops import fused_mlp
from videollm_online_tpu_torch.serve import cli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jax.device_get(x)).astype(
        np.float32 if x.dtype == jnp.bfloat16 else x.dtype)


def _bf16(a):
    """A numpy fp32 array rounded to bf16 as both frameworks' tensors."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_equal(got[k], want[k])
    else:
        g, w = _np(got), _np(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------- quantizers
@pytest.mark.parametrize("shape,group", [((256, 512), 128), ((64, 128), 128),
                                         ((2, 128, 64), 32)])
@pytest.mark.parametrize("layout", ["q4p", "q4c"])
def test_int4_quantizers_bit_identical(layout, shape, group):
    """Packed bytes and scales equal to the JAX package's bit for bit, the
    dequantized matrices too (fp32 and bf16)."""
    w = (np.random.RandomState(0).randn(*shape) * 0.05).astype(np.float32)
    w[..., 3, :] = 0.0      # an all-zero row
    w[..., :, 5] = 0.0      # an all-zero column: scale 1
    jfn, fn = {"q4p": (jax_quant.quantize_weight_int4,
                       quant.quantize_weight_int4),
               "q4c": (jax_quant.quantize_weight_int4c,
                       quant.quantize_weight_int4c)}[layout]
    want = jfn(jnp.asarray(w), group=group)
    got = fn(torch.from_numpy(w), group=group)
    _tree_equal(got, want)
    assert got[layout].dtype == torch.int8
    for jdt, dt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _np(quant.dequantize_weight(got, dtype=dt)),
            _np(jax_quant.dequantize_weight(want, dtype=jdt)))


def test_int4c_decodes_every_byte():
    """Random bytes are valid column-packed data: the port decodes all 256
    byte values as the JAX package does."""
    p = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    scale = np.ones((1, 32), np.float32)
    want = jax_quant._dequantize_int4c({"q4c": jnp.asarray(p),
                                        "scale": jnp.asarray(scale)},
                                       jnp.float32)
    got = quant._dequantize_int4c({"q4c": torch.from_numpy(p),
                                   "scale": torch.from_numpy(scale)},
                                  torch.float32)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(fused_mlp._q4c(torch.from_numpy(p))), _np(want))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_llama_params_bit_identical_and_crosses_the_bridge(bits):
    """``quantize_llama_params`` on the same fp32 tree gives the JAX
    package's tree bit for bit (for 4 bits the mixed layout: MLP and
    lm_head q4c, attention and embedding int8), and the JAX tree carried
    over by ``params_from_numpy`` is that same tree: packed bytes stay
    int8, every scale fp32, also with a bf16 recast of the other leaves."""
    jcfg = jax_tiny_live()
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(0), jcfg))
    want = jax.device_get(jax_quant.quantize_llama_params(
        jparams["llama"], bits=bits))
    got = quant.quantize_llama_params(
        params_from_numpy(jparams["llama"], device="cpu"), bits=bits)
    _tree_equal(got, want)
    carried = params_from_numpy(want, device="cpu")
    _tree_equal(carried, want)
    recast = params_from_numpy(want, device="cpu", dtype=torch.bfloat16)
    mlp_key = "q4c" if bits == 4 else "q8"
    for name in ("w_gate", "w_up", "w_down"):
        leaf = recast["layers"][name]
        assert leaf[mlp_key].dtype == torch.int8
        assert leaf["scale"].dtype == torch.float32
        assert leaf["scale"].ndim == (3 if bits == 4 else 2)
    assert mlp_key in recast["lm_head"] and "q8" in recast["embed"]
    assert "q8" in recast["layers"]["wq"]
    assert recast["final_norm"].dtype == torch.bfloat16
    assert quant.is_quantized(got["lm_head"]) and not quant.is_quantized(
        got["final_norm"])


def test_random_quantized_params_int4_layout():
    """Random int4 params have the shapes, types and scale values of the JAX
    package's (the bytes come from another generator by design)."""
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=384,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    want = jax.device_get(jax_quant.random_quantized_llama_params(
        jax.random.PRNGKey(0), cfg, bits=4))
    got = quant.random_quantized_llama_params(
        torch.Generator().manual_seed(0), cfg, bits=4, device="cpu")

    def check(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                check(g[k], w[k])
        else:
            assert _np(g).dtype == _np(w).dtype and g.shape == w.shape

    check(got, want)
    for name in ("w_gate", "w_down"):
        np.testing.assert_array_equal(_np(got["layers"][name]["scale"]),
                                      _np(want["layers"][name]["scale"]))
    np.testing.assert_array_equal(_np(got["lm_head"]["scale"]),
                                  _np(want["lm_head"]["scale"]))
    assert int(got["layers"]["w_up"]["q4c"].min()) == -128
    with pytest.raises(ValueError):
        quant.random_quantized_llama_params(torch.Generator(), cfg, bits=2,
                                            device="cpu")


# ------------------------------------------- plain versions vs Pallas kernels
def _mlp_weights(layout, D, F, seed):
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(*s) * 0.05).astype(np.float32)
          for s in ((D, F), (D, F), (F, D))]
    jq, tq, key = {
        "q8": (lambda w: jax_quant.quantize_weight(w, axis=-2),
               lambda w: quant.quantize_weight(w, axis=-2), "q8"),
        "q4p": (jax_quant.quantize_weight_int4, quant.quantize_weight_int4,
                "q4p"),
        "q4c": (jax_quant.quantize_weight_int4c, quant.quantize_weight_int4c,
                "q4c")}[layout]
    jw = [jq(jnp.asarray(w)) for w in ws]
    tw = [tq(torch.from_numpy(w)) for w in ws]
    flat_j = [a for q in jw for a in (q[key], q["scale"])]
    flat_t = [a for q in tw for a in (q[key], q["scale"])]
    return flat_j, flat_t, rng


# the shapes of tests/test_fused_mlp.py
MLP_CASES = [("q8", 1, 256, 512, 256), ("q8", 8, 256, 1024, 256),
             ("q4p", 1, 256, 1024, 256), ("q4p", 4, 256, 1024, 128),
             ("q4p", 8, 512, 512, 128),
             ("q4c", 1, 256, 1024, 256), ("q4c", 4, 256, 1024, 128),
             ("q4c", 8, 512, 512, 128)]


@pytest.mark.parametrize("layout,B,D,F,block_f", MLP_CASES)
def test_plain_mlp_matches_pallas_interpret(layout, B, D, F, block_f):
    """The plain version of K6 / K7 / K4 against the JAX kernel in interpret
    mode, on bf16 outputs of magnitude about 0.5 (ulp 2e-3 to 4e-3). K6 and
    K4 round x and h to bf16 and scale fp32 sums on both sides, and differ
    only in the order of the fp32 sums (K4's TPU form recovers the low
    nibble from a difference of partial sums), which can move an output by
    an ulp: atol 4e-3, relative norm error 1e-4 (read: 0 to 2.2e-5). K7's
    TPU form rounds every dequantized weight q * scale to bf16 before the
    product (one part in 2^9 per weight), while the port's kernels keep the
    integer values exact and scale each group's fp32 sum: atol 3e-2 and a
    relative norm error of 1e-2 (read: 4.3e-3), and the port's version must
    be at least as close to the product taken in fp32 as the JAX kernel."""
    flat_j, flat_t, rng = _mlp_weights(layout, D, F, seed=D + F + B)
    xt, xj = _bf16(rng.randn(B, D).astype(np.float32))
    jfn, fn = {"q8": (jax_fused.fused_mlp_int8, fused_mlp.fused_mlp_int8),
               "q4p": (jax_fused.fused_mlp_int4, fused_mlp.fused_mlp_int4),
               "q4c": (jax_fused.fused_mlp_int4c, fused_mlp.fused_mlp_int4c)
               }[layout]
    want = _np(jfn(xj, *flat_j, block_f=block_f, interpret=True))
    got = fn(xt, *flat_t)
    assert got.dtype == torch.bfloat16 and got.shape == (B, D)
    got = _np(got)
    atol, rel = (3e-2, 1e-2) if layout == "q4p" else (4e-3, 1e-4)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)
    if layout == "q4p":
        wg, wu, wd = (quant.dequantize_weight(
            {"q4p": flat_t[i], "scale": flat_t[i + 1]}, dtype=torch.float32)
            for i in (0, 2, 4))
        xf = xt.float()
        truth = _np((torch.nn.functional.silu(xf @ wg) * (xf @ wu)) @ wd)
        assert np.abs(got - truth).mean() <= np.abs(want - truth).mean() + 1e-6


def test_plain_matmul_int4c_exact_integers():
    """Small-integer activations and scale 1: every product and sum is exact
    in fp32, so the plain K5 equals the dequantized matmul and the JAX
    kernel bit for bit."""
    rng = np.random.RandomState(0)
    K, N = 256, 512
    q = rng.randint(-7, 8, (K, N)).astype(np.float32)
    packed = (16 * q[:, N // 2:] + q[:, : N // 2] + 8).astype(np.int8)
    scale = np.ones((K // 128, N), np.float32)
    x = rng.randint(-4, 5, (2, K)).astype(np.float32)
    got = fused_mlp.matmul_int4c(torch.from_numpy(x), torch.from_numpy(packed),
                                 torch.from_numpy(scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), x @ q)
    want = jax_fused.matmul_int4c(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(packed), jnp.asarray(scale),
                                  block_n=128, interpret=True)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_plain_matmul_int4c_matches_pallas_interpret():
    """K5's plain version against the JAX kernel in interpret mode on the
    shape of tests/test_fused_mlp.py: fp32 sums in another order, atol =
    rtol = 1e-4 on fp32 outputs of magnitude about 1."""
    rng = np.random.RandomState(5)
    K, N = 256, 768
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    jq = jax_quant.quantize_weight_int4c(jnp.asarray(w))
    tq = quant.quantize_weight_int4c(torch.from_numpy(w))
    xt, xj = _bf16(rng.randn(3, K).astype(np.float32))
    want = jax_fused.matmul_int4c(xj, jq["q4c"], jq["scale"], block_n=128,
                                  interpret=True)
    got = fused_mlp.matmul_int4c(xt, tq["q4c"], tq["scale"])
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layout", ["q4c", "q4p", "q8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_matches_jax_fallback(layout, dtype):
    """The dequantizing route (x @ the matrix dequantized in x's dtype)
    against the JAX package's. fp32: the same products, sums in another
    order, atol 1e-5. bf16: the weight is rounded alike, the product's
    rounding differs by an ulp of outputs of magnitude about 1: atol 2e-2."""
    rng = np.random.RandomState(7)
    K, N = 128, 96
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    x = rng.randn(5, K).astype(np.float32)
    jfn, fn = {"q4c": (jax_quant.quantize_weight_int4c,
                       quant.quantize_weight_int4c),
               "q4p": (lambda a: jax_quant.quantize_weight_int4(a, group=32),
                       lambda a: quant.quantize_weight_int4(a, group=32)),
               "q8": (jax_quant.quantize_weight, quant.quantize_weight)
               }[layout]
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_quant.quantized_matmul(jnp.asarray(x).astype(jdt),
                                      jfn(jnp.asarray(w)))
    got = quant.quantized_matmul(torch.from_numpy(x).to(dt),
                                 fn(torch.from_numpy(w)))
    assert got.dtype == dt
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-5 if dtype == "float32" else 2e-2)


# ------------------------------------------------------------------ dispatch
def _layer_params(layout, D=64, F=128, group=128):
    fn = {"q4c": lambda w: quant.quantize_weight_int4c(w, group=group),
          "q4p": lambda w: quant.quantize_weight_int4(w, group=group),
          "q8": lambda w: quant.quantize_weight(w, axis=-2),
          "plain": lambda w: w}[layout]
    rng = np.random.RandomState(1)
    return {n: fn(torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32)))
            for n, s in (("w_gate", (D, F)), ("w_up", (D, F)),
                         ("w_down", (F, D)))}


@pytest.fixture
def recorder(monkeypatch):
    """The kernels' wrappers replaced by recorders, the tensors taken to lie
    on the card."""
    calls = []
    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    for name in ("mlp_int4c", "mlp_int4", "mlp_int8"):
        monkeypatch.setattr(fused_mlp, name,
                            lambda x, lp, _n=name: calls.append(_n) or x)
    monkeypatch.setattr(
        fused_mlp, "matmul_int4c",
        lambda x, w, s: calls.append("matmul_int4c") or torch.zeros(
            (x.shape[0], s.shape[-1])))
    return calls


DISPATCH = [
    # layout, rows (B, S), LoRA, expected wrapper
    ("q4c", (1, 1), None, "mlp_int4c"),
    ("q4c", (1, 128), None, "mlp_int4c"),
    ("q4c", (2, 64), None, "mlp_int4c"),
    ("q4c", (1, 129), None, None),
    ("q4c", (1, 20), {"wq": {}}, "mlp_int4c"),
    ("q4c", (1, 20), {"w_up": {}}, None),
    ("q4p", (1, 91), None, "mlp_int4"),
    ("q8", (1, 1), None, None),
    ("plain", (1, 1), None, None),
    ("mixed", (1, 1), None, None),
    # groups of 8 rows, which the kernels do not take (the JAX rule sends
    # q4c at this shape to its Pallas kernel): the dequantizing route
    ("q4c/8", (1, 1), None, None),
    ("q4p/8", (1, 20), None, None),
]


@pytest.mark.parametrize("layout,rows,lora,want", DISPATCH)
def test_maybe_fused_dispatch_table(recorder, layout, rows, lora, want):
    """The dispatch of one layer's MLP (layout "key/group" for a group other
    than 128): a shape the kernels do not take returns None, never
    raises."""
    layout, _, group = layout.partition("/")
    if layout == "mixed":
        lp = _layer_params("q4c")
        lp["w_down"] = _layer_params("q4p")["w_down"]
    else:
        lp = _layer_params(layout, group=int(group or 128))
    x = torch.ones(rows + (64,), dtype=torch.bfloat16)
    out = fused_mlp.maybe_fused(x, lp, lora)
    assert recorder == ([want] if want else [])
    assert (out is not None) == (want is not None)


def test_dispatch_declines_off_the_card_and_when_switched_off(
        recorder, monkeypatch):
    lp = _layer_params("q4c")
    x = torch.ones((1, 1, 64), dtype=torch.bfloat16)
    head = quant.quantize_weight_int4c(torch.ones((64, 32)))
    monkeypatch.setenv("VLO_FUSED_MLP", "0")
    assert fused_mlp.maybe_fused(x, lp, None) is None
    assert fused_mlp.maybe_matmul_int4c(x, head) is None
    monkeypatch.delenv("VLO_FUSED_MLP")
    monkeypatch.setattr(fused_mlp, "_on_card", lambda t: t.is_cuda)
    assert fused_mlp.maybe_fused(x, lp, None) is None
    assert fused_mlp.maybe_matmul_int4c(x, head) is None
    assert recorder == []


@pytest.mark.parametrize("lead,want", [((1, 1), True), ((2, 64), True),
                                       ((129,), False), ((0,), False)])
def test_maybe_matmul_int4c_dispatch(recorder, lead, want):
    head = quant.quantize_weight_int4c(torch.ones((64, 32)))
    x = torch.ones(lead + (64,), dtype=torch.bfloat16)
    y = fused_mlp.maybe_matmul_int4c(x, head)
    assert (y is not None) == want == (recorder == ["matmul_int4c"])
    if want:
        assert y.shape == lead + (32,) and y.dtype == torch.float32
    # a stacked (L, K, N/2) leaf, an int8 leaf and groups of 8 rows (which
    # the kernel does not take) are not K5's
    stacked = {"q4c": head["q4c"][None], "scale": head["scale"][None]}
    assert fused_mlp.maybe_matmul_int4c(x, stacked) is None
    assert fused_mlp.maybe_matmul_int4c(
        x, quant.quantize_weight(torch.ones((64, 32)))) is None
    assert fused_mlp.maybe_matmul_int4c(
        x, quant.quantize_weight_int4c(torch.ones((64, 32)), group=8)) is None


def test_cuda_only_wrapper_takes_plain_version_only_for_cpu_tensors():
    """On a CPU tensor the wrappers run their plain versions and count no
    launch."""
    lp = _layer_params("q4c")
    x = torch.ones((1, 3, 64), dtype=torch.float32)
    before = fused_mlp.fused_mlp_int4c.launches
    y = fused_mlp.mlp_int4c(x, lp)
    assert y.shape == x.shape and y.dtype == x.dtype
    assert fused_mlp.fused_mlp_int4c.launches == before


# K4's wgmma kernel: (D, F) of the 8B model and of the odd cases chip_smoke.py
# holds on the card, and the rows the main paths send
Q4C_SHAPES = [(4096, 14336), (64, 128), (192, 320), (256, 512), (128, 384),
              (48, 80)]
Q4C_ROWS = [1, 3, 7, 17, 20, 33, 91, 128]


def _intervals(spans, end):
    """The distinct (start, stop) spans, checked to chain from 0 to end."""
    spans = sorted(set(spans))
    assert [a for a, _ in spans] == [0] + [b for _, b in spans[:-1]]
    assert spans[-1][1] == end and all(a < b for a, b in spans)
    return spans


@pytest.mark.parametrize("D,F", Q4C_SHAPES)
@pytest.mark.parametrize("B", Q4C_ROWS)
def test_q4c_work_units_cover_every_byte_column_and_row_once(D, F, B):
    """K4's work decomposition (q4c_units, the order the CUDA kernel walks)
    covers every (matrix, byte column, reduction row) of each product
    exactly once: per matrix the units are the product of a partition of
    the byte columns and one of the reduction rows, with no unit twice;
    splits start on KT rows, and no CTA is idle, on 132 SMs and on 5."""
    for sms in (132, 5):
        for rows, cols, mats in ((D, F // 2, 2), (F, D // 2, 1)):
            bc, splits, per, grid = fused_mlp.q4c_schedule(rows, cols, B,
                                                           mats, sms)
            assert per % fused_mlp.KT == 0 and splits * per >= rows
            work = fused_mlp.q4c_units(rows, cols, B, mats, sms)
            assert len(work) == grid <= sms and all(work)
            units = [u for cta in work for u in cta]
            assert len(set(units)) == len(units)
            for mat in range(mats):
                mine = [u for u in units if u[0] == mat]
                col_spans = _intervals([(c0, c1) for _, c0, c1, _, _ in mine],
                                       cols)
                row_spans = _intervals([(r0, r1) for _, _, _, r0, r1 in mine],
                                       rows)
                assert all(r0 % fused_mlp.KT == 0 for r0, _ in row_spans)
                assert all(c1 - c0 <= bc for c0, c1 in col_spans)
                assert len(mine) == len(col_spans) * len(row_spans)
            assert {u[0] for u in units} == set(range(mats))


def test_q4c_rows_and_tiles():
    """N, the rows of x a wgmma product of K4 serves, is B rounded up to
    8, 16, 32, 64 or 128; a tile's byte columns shrink as N grows, so the
    accumulators stay at MT * N = 128 a thread or fewer."""
    assert [fused_mlp.q4c_rows(b)
            for b in (1, 2, 4, 5, 8, 9, 20, 33, 64, 91, 128)] \
        == [8, 8, 8, 8, 8, 16, 32, 64, 64, 128, 128]
    for b in (1, 20, 33, 91):
        mt = fused_mlp.q4c_tile(b) // 64
        assert mt * fused_mlp.q4c_rows(b) <= 128 and mt in (1, 2, 4)


# The streaming core of K5, K6 and K7: (label, layout, byte rows (the
# reduction rows; half of them for q4p), byte columns, group, matrices) of
# the 8B head (V 128256: 501 strips of 128 byte columns, the last of them
# its tail), K6's and K7's gate/up and down products, and odd shapes with a
# strip tail (N 2080 at groups of 64; D 80, F 176; K7 at D 384, F 1040,
# groups of 64)
WO_SHAPES = [("K5 8B", 0, 4096, 64128, 128, 1),
             ("K6 gate/up 8B", 2, 4096, 14336, 4096, 2),
             ("K6 down 8B", 2, 14336, 4096, 14336, 1),
             ("K5 N 2080", 0, 256, 1040, 64, 1),
             ("K6 D 80 F 176", 2, 80, 176, 80, 2),
             ("K7 gate/up 8B", 1, 2048, 14336, 128, 2),
             ("K7 down 8B", 1, 7168, 4096, 128, 1),
             ("K7 D 384 F 1040", 1, 192, 1040, 64, 2)]


@pytest.mark.parametrize("shape", WO_SHAPES, ids=[s[0] for s in WO_SHAPES])
@pytest.mark.parametrize("B", [1, 8, 20, 91, 128])
def test_wo_work_units_cover_every_byte_column_and_row_once(shape, B):
    """The streaming core's work decomposition (wo_units, the order the
    CUDA kernel walks) covers every (matrix, x row, byte column, reduction
    row) exactly once: per matrix the units are the product of partitions
    of the x rows (blocks of N), the byte columns (strips of 128)
    and the byte rows (splits on a slot, and for int4 at more than one
    split on a group; for q4p the high half's split, K / 2 further, too);
    no unit twice; every CTA has work; on 132 SMs and on 5."""
    _, layout, rows, cols, group, mats = shape
    for sms in (132, 5):
        n, splits, per, grid = fused_mlp.wo_schedule(layout, rows, cols, B,
                                                     group, mats, sms)
        assert n == fused_mlp.wo_design(layout, B)
        assert B <= n or n == 64
        assert per % fused_mlp.WO_KW == 0 and splits * per >= rows
        if splits > 1 and layout != fused_mlp.LAYOUT_Q8:
            assert per % group == 0
        if splits > 1 and layout == fused_mlp.LAYOUT_Q4P:
            assert all((r0 + rows) % group == 0
                       for r0 in range(0, rows, per))
        work = fused_mlp.wo_units(layout, rows, cols, B, group, mats, sms)
        gpc = fused_mlp.WO_WARPS // fused_mlp.wo_group_warps(layout, n)
        assert len(work) == grid * gpc and grid <= sms
        assert all(any(work[j * grid + c] for j in range(gpc))
                   for c in range(grid))
        units = [u for w in work for u in w]
        assert len(set(units)) == len(units)
        for mat in range(mats):
            mine = [u for u in units if u[0] == mat]
            x_spans = _intervals([(b0, b1) for _, b0, b1, *_ in mine], B)
            col_spans = _intervals([(c0, c1) for *_, c0, c1, _, _ in mine],
                                   cols)
            row_spans = _intervals([(r0, r1) for *_, r0, r1 in mine], rows)
            assert all(b1 - b0 <= n for b0, b1 in x_spans)
            assert all(c1 - c0 <= fused_mlp.WO_STRIP for c0, c1 in col_spans)
            assert all(r0 % per == 0 for r0, _ in row_spans)
            assert len(mine) == (len(x_spans) * len(col_spans)
                                 * len(row_spans))
        assert {u[0] for u in units} == set(range(mats))


@pytest.mark.parametrize("layout,K,N,group,want", [
    ("q4p", 4096, 14336, 128, True),     # K7's 8B gate/up
    ("q4p", 14336, 4096, 128, True),     # K7's 8B down
    ("q4p", 384, 1040, 64, True),        # a strip tail
    ("q4p", 512, 1024, 256, True),       # two slots a group
    ("q4p", 320, 1088, 32, True),        # two groups a slot
    ("q4p", 64, 128, 64, False),         # one group spans both halves
    ("q4p", 384, 256, 128, False),       # K / 2 = 192: not a multiple
    ("q4p", 96, 160, 32, False),         # K / 2 = 48: not a multiple
    ("q4p", 240, 256, 16, False),        # K / 2 = 120: not 16-aligned
    ("q4p", 192, 256, 48, False),        # a group that does not tile a slot
    ("q4p", 256, 1000, 128, False),      # byte rows not 16-byte aligned
    ("q4c", 4096, 128256, 128, True),    # K5's 8B head
    ("q4c", 256, 1000, 64, False),       # 500-byte rows
    ("q8", 80, 176, 0, True),
    ("q8", 80, 100, 0, False)])
def test_wo_takes_shape_rule(layout, K, N, group, want):
    """_wo_takes, the rule the wrappers apply before any launch (and
    csrc/fused_mlp.cu's launch_design holds): byte rows 16-byte aligned;
    an int4 group a multiple of 16 that divides a 64-row slot or is a
    multiple of one; for q4p half the reduction dim a multiple of 16 and
    of the group, so a low-half group and its high-half partner end in
    one slot."""
    code = {"q4c": fused_mlp.LAYOUT_Q4C, "q4p": fused_mlp.LAYOUT_Q4P,
            "q8": fused_mlp.LAYOUT_Q8}[layout]
    w = torch.zeros({"q4c": (K, N // 2), "q4p": (K // 2, N),
                     "q8": (K, N)}[layout], dtype=torch.int8)
    s = torch.ones((N,) if layout == "q8" else (K // group, N))
    assert w.data_ptr() % 16 == 0
    assert fused_mlp._wo_takes(code, ((w, s),)) == want


def _bf16_bits(bits):
    """int32 tensor of 16-bit patterns -> the bf16 values they encode."""
    return bits.to(torch.int16).view(torch.bfloat16)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on int64 tensors of 32-bit words: byte i of the
    result is byte (sel >> 4 i) & 7 of the eight bytes of y:x."""
    xy = x | (y << 32)
    out = torch.zeros_like(x)
    for i in range(4):
        out |= ((xy >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
    return out


def _q4_hi(v):
    """csrc/fused_mlp.cu's q4_hi: the two's-complement nibbles at bits 0-3
    and 16-19 of v, bit 3 flipped into 0x43XX (bf16 128 + v + 8), less bf16
    136: the bf16 pair as (low half, high half)."""
    w = (v & 0x000F000F) ^ 0x43084308
    bias = torch.tensor(136.0, dtype=torch.bfloat16)
    return (_bf16_bits(w & 0xFFFF) - bias).float(), \
        (_bf16_bits((w >> 16) & 0xFFFF) - bias).float()


def _q4p_pair(r0, r1, r2, r3, j):
    """csrc/fused_mlp.cu's q4p_pair step for step: the low half's and the
    high half's A fragments (four bf16 pairs each) of bytes j, j + 1."""
    sel = j | ((j + 1) << 4) | ((j + 4) << 8) | ((j + 5) << 12)
    p, q = _byte_perm(r0, r1, sel), _byte_perm(r2, r3, sel)
    lo = [_q4_hi(p), _q4_hi(p >> 8), _q4_hi(q), _q4_hi(q >> 8)]
    hi = [_q4_hi(p >> 4), _q4_hi(p >> 12), _q4_hi(q >> 4), _q4_hi(q >> 12)]
    return lo, hi


@pytest.mark.parametrize("layout", ["q8", "q4c", "q4p"])
def test_streaming_core_decode_is_exact_for_every_byte(layout):
    """A model of the streaming core's decode, step for step on int32
    tensors, gives every one of the 256 byte values exactly: int8 by
    __byte_perm into 0x4B0000XX (the byte xored with 0x80), one fp32
    subtraction of 2^23 + 128 and the high half as bf16 (no I2F); q4c's
    low nibble as 0x43XX (bf16 128 + v + 8) and its high nibble with bit 3
    flipped, each less bf16 136; q4p's two nibbles both as q4c's high
    nibble, gathered by q4p_pair into the A fragments of rows g and g + 8
    (bytes j, j + 1) for the low half's k-step and the high half's, equal
    to quant._unpack_nibbles."""
    b = torch.arange(256, dtype=torch.int32)
    signed = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.int8).to(torch.int32)
    if layout == "q4p":
        # four words (byte rows 2t, 2t + 1, 2t + 8, 2t + 9) whose bytes
        # take every value at every position, no two bytes alike in a lane
        v = torch.arange(256, dtype=torch.int64)
        byte = [[(v + 64 * k + 16 * i + 5 * k * i) % 256 for i in range(4)]
                for k in range(4)]
        words = [sum(byte[k][i] << (8 * i) for i in range(4))
                 for k in range(4)]
        for j in (0, 2):
            lo, hi = _q4p_pair(*words, j)
            for half, frag in enumerate((lo, hi)):
                for reg in range(4):
                    # register reg: rows g (even reg) or g + 8 (odd), i.e.
                    # byte j or j + 1; k 2t, 2t + 1 (reg < 2) or + 8, + 9
                    i, k0 = j + reg % 2, 2 * (reg // 2)
                    for e in range(2):
                        packed = byte[k0 + e][i].to(torch.uint8).view(
                            torch.int8)[None, :]
                        want = quant._unpack_nibbles(packed, torch.float32)
                        np.testing.assert_array_equal(
                            frag[reg][e].numpy(), want[half].numpy())
        return
    if layout == "q8":
        f = (0x4B000000 | (b ^ 0x80)).view(torch.float32) - 8388736.0
        got = _bf16_bits(f.view(torch.int32) >> 16).float()
        want = signed.float()
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    bias = torch.tensor(136.0, dtype=torch.bfloat16)
    lo = _bf16_bits((b & 0x0F) | 0x4300) - bias
    hi = _bf16_bits(((b >> 4) & 0x0F) ^ 0x4308) - bias
    want = quant._unpack_int4c(signed.to(torch.int8)[None, :],
                               torch.float32)[0]
    np.testing.assert_array_equal(lo.float().numpy(), want[:256].numpy())
    np.testing.assert_array_equal(hi.float().numpy(), want[256:].numpy())


# ------------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def int4_pair():
    jcfg = jax_tiny_live()
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(0), jcfg))
    jq = jax.device_get(jax_quant.quantize_llama_params(jparams["llama"],
                                                        bits=4))
    return jcfg.llama, jq, tiny_live_config().llama, params_from_numpy(
        jq, device="cpu")


def test_int4_forward_matches_jax(int4_pair):
    """``llama.forward`` on the mixed int4 layout, both packages on their
    dequantizing route (the CPU): fp32, sums in another order, atol 1e-4 as
    for int8 weights."""
    jcfg, jq, cfg, params = int4_pair
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 17))
    want, _ = jax_llama.forward(jq, cfg=jcfg, input_ids=jnp.asarray(ids))
    got, _ = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    # with a cache: the rank-3 (L, in/group, out) scales are sliced per layer
    jcache = jax_llama.init_kv_cache(jcfg, batch=2, capacity=32,
                                     dtype=jnp.float32)
    cache = llama.init_kv_cache(cfg, batch=2, capacity=32, device="cpu")
    want, _ = jax_llama.forward(jq, cfg=jcfg, input_ids=jnp.asarray(ids),
                                kv_cache=jcache)
    got, _ = llama.forward(params, cfg=cfg, input_ids=torch.tensor(ids),
                           kv_cache=cache)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    assert llama._index_tree(params["layers"], 1)["w_gate"]["scale"].shape \
        == (1, cfg.intermediate_size)


def test_tied_embedding_error_names_quantized_layouts(int4_pair):
    _, _, cfg, params = int4_pair
    import dataclasses
    tied = dataclasses.replace(cfg, tie_word_embeddings=True)
    with pytest.raises(ValueError, match="int8 / int4"):
        llama.lm_head(params, torch.zeros((1, 1, cfg.hidden_size)), tied)


def test_one_layer_through_the_fused_numerics(monkeypatch):
    """One layer with its MLP through K4's numerics on both sides: the
    port's dispatch forced to the kernel's plain version, the JAX layer's
    to its Pallas kernel in interpret mode (patched here, nothing in the
    JAX package changes). x and h are rounded to bf16 on both sides; the
    fp32 sums differ in order and may move h by a bf16 ulp: atol 1e-3 on
    fp32 hidden states of magnitude about 1."""
    # F = 256: two groups of 128 rows in the down matrix, which the JAX
    # dispatch's TPU block guards want (an even number of F groups)
    from videollm_online_tpu.core.config import tiny_llama_config as jax_tiny
    from videollm_online_tpu_torch.core.config import tiny_llama_config
    jcfg, cfg = jax_tiny(intermediate_size=256), tiny_llama_config(
        intermediate_size=256)
    jq = jax.device_get(jax_quant.quantize_llama_params(
        jax_llama.init_params(jax.random.PRNGKey(0), jcfg), bits=4))
    params = params_from_numpy(jq, device="cpu")
    rng = np.random.RandomState(3)
    B, S = 1, 9
    h = rng.randn(B, S, cfg.hidden_size).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]

    calls = []
    real = jax_fused.mlp_int4c

    def interpreted(x, lp, **kw):
        calls.append("jax")
        return real(x, lp, interpret=True)

    monkeypatch.setattr(jax_fused, "mlp_int4c", interpreted)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jlp = jax.tree.map(lambda a: a[0], jq["layers"])
    jcos, jsin = jax_llama.rope_cos_sin(jnp.asarray(pos), jcfg.head_dim,
                                        jcfg.rope_theta)
    want, _ = jax_llama._layer(jnp.asarray(h), jlp, None, jcos, jsin,
                               jnp.asarray(pos), None, jcfg, 1.0,
                               jax_llama._attention)
    monkeypatch.undo()

    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    real_t = fused_mlp.fused_mlp_int4c

    def counted(*a):
        calls.append("torch")
        return real_t(*a)

    monkeypatch.setattr(fused_mlp, "fused_mlp_int4c", counted)
    cos, sin = llama.rope_cos_sin(torch.from_numpy(pos), cfg.head_dim,
                                  cfg.rope_theta)
    got = llama._layer(torch.from_numpy(h), llama._index_tree(
        params["layers"], 0), None, cos, sin, torch.from_numpy(pos), None,
        cfg, 1.0, llama._attention)
    assert calls == ["jax", "torch"]
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-3)
    # and the fused numerics are not the dequantizing route's
    monkeypatch.undo()
    plain = llama._layer(torch.from_numpy(h), llama._index_tree(
        params["layers"], 0), None, cos, sin, torch.from_numpy(pos), None,
        cfg, 1.0, llama._attention)
    assert not np.array_equal(_np(plain), _np(got))


# ----------------------------------------------------------------------- CLI
def _cli_args(**kw):
    base = dict(video="", checkpoint="", vision_checkpoint="", tokenizer="",
                model_size="tiny", dtype="float32", quantize="", device="cpu",
                with_vision=False, seed=0, kv_capacity=1024,
                speculative=False, spec_decode=False, spec_draft=0,
                pipelined=False, stream_tokens=0, kv_quant="")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture
def small_sizes(monkeypatch):
    """--model_size 8b at a small width: the layout rule is checked on the
    tree's keys and shapes, not by building 8B here."""
    small = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                 num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32)
    monkeypatch.setitem(cli.PROXY_SIZES, "8b", small)
    return small


def test_cli_build_model_layouts(small_sizes):
    D, F, V = 128, 256, 512
    params, tok, cfg, vision = cli.build_model(
        _cli_args(model_size="8b", quantize="int4"))
    lm = params["llama"]
    assert vision is None and cfg.lora is None and "lora" not in params
    for name, shape in (("w_gate", (2, D, F // 2)), ("w_up", (2, D, F // 2)),
                        ("w_down", (2, F, D // 2))):
        assert lm["layers"][name]["q4c"].shape == shape
        assert lm["layers"][name]["q4c"].dtype == torch.int8
    assert lm["layers"]["w_down"]["scale"].shape == (2, F // 128, D)
    assert lm["lm_head"]["q4c"].shape == (D, V // 2)
    assert "q8" in lm["layers"]["wq"] and "q8" in lm["embed"]
    assert params["connector"]["fc1"]["w"].dtype == torch.float32
    # 8b alone: int8 everywhere
    lm8 = cli.build_model(_cli_args(model_size="8b"))[0]["llama"]
    assert all("q8" in lm8["layers"][n] for n in ("wq", "w_gate", "w_down"))
    assert "q8" in lm8["lm_head"]
    # tiny without --quantize: plain weights; the seed decides them
    a = cli.build_model(_cli_args(seed=1))[0]["llama"]["layers"]["wq"]
    b = cli.build_model(_cli_args(seed=1))[0]["llama"]["layers"]["wq"]
    c = cli.build_model(_cli_args(seed=2))[0]["llama"]["layers"]["wq"]
    assert torch.is_tensor(a) and torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("flag", [
    {"with_vision": True}, {"vision_checkpoint": "x"}, {"kv_quant": "int8"},
    {"speculative": True}, {"pipelined": True}, {"stream_tokens": 4}])
def test_cli_refuses_what_the_engine_does_not_carry(flag, tmp_path, capsys):
    """Every engine option the cli names builds: the dispatch modes
    (--speculative, --pipelined) too, and ``cli.main`` with one prints and
    saves the dialogue of the blocking cli, the tail ``flush()`` resolves
    included; a vision checkpoint that is not there raises."""
    if "speculative" in flag or "pipelined" in flag:
        engine, _ = cli.build_engine(_cli_args(**flag))
        assert engine.speculative == bool(flag.get("speculative"))
        assert engine.pipelined == bool(flag.get("pipelined"))
        feats = np.random.RandomState(1).randn(6, 10, 1024).astype(
            np.float32)
        np.save(tmp_path / "feats.npy", feats)
        argv = ["--device", "cpu", "--model_size", "tiny", "--dtype",
                "float32", "--video", str(tmp_path / "feats.npy"),
                "--num_ticks", "6", "--kv_capacity", "1024"]
        dialogues = []
        for extra in ([], ["--" + next(iter(flag))]):
            cli.main(argv + extra + ["--output", str(tmp_path / "h.json")])
            printed = capsys.readouterr().out
            messages = json.loads((tmp_path / "h.json").read_text())[
                "messages"]
            assert all(m["content"] in printed for m in messages)
            dialogues.append([(m["role"], m["content"]) for m in messages])
        assert dialogues[1] == dialogues[0] and len(dialogues[0]) >= 3
        return
    if "vision_checkpoint" in flag:
        with pytest.raises(FileNotFoundError):
            cli.build_engine(_cli_args(**flag))
        return
    engine, cfg = cli.build_engine(_cli_args(**flag))
    if "with_vision" in flag:
        assert engine.vision_params["layers"]["q"]["w"].shape[0] == \
            cfg.vision.num_layers
    if "kv_quant" in flag:
        assert engine.cache.k.dtype == torch.int8
    if "stream_tokens" in flag:
        assert engine.stream_tokens == 4 and engine.max_new == 4
        assert cfg.max_response_tokens % 4 == 0


def test_cli_main_runs_int4_and_writes_history(tmp_path, capsys):
    feats = np.random.RandomState(0).randn(6, 10, 1024).astype(np.float32)
    video = tmp_path / "feats.npy"
    np.save(video, feats)
    out = tmp_path / "history.json"
    cli.main(["--device", "cpu", "--model_size", "tiny", "--quantize", "int4",
              "--dtype", "float32", "--video", str(video), "--num_ticks", "5",
              "--warmup_ticks", "1", "--kv_capacity", "1024",
              "--spec_decode", "--output", str(out)])
    printed = capsys.readouterr().out
    assert "Average Processing FPS:" in printed
    history = json.loads(out.read_text())
    assert set(history) == {"video", "messages", "average_processing_fps"}
    assert history["video"] == str(video)
    assert history["average_processing_fps"] > 0
    assert history["messages"][0]["role"] == "user"
    assert all(set(m) == {"role", "content", "fps"}
               for m in history["messages"])
    assert any(m["role"] == "assistant" for m in history["messages"])


def test_cli_checkpoint_loads_adapter_and_quantizes(tmp_path):
    """--checkpoint takes what train/checkpoints.save_adapter writes; the
    base is quantized when --quantize asks, the adapter stays as saved."""
    from videollm_online_tpu_torch.models import live
    from videollm_online_tpu_torch.train import checkpoints
    cfg = tiny_live_config()
    llama_cfg = LlamaConfig(**cli.PROXY_SIZES["tiny"], dtype="float32")
    cfg = cfg.replace(llama=llama_cfg, vision_hidden_size=1024)
    params = live.init_params(torch.Generator().manual_seed(5), cfg,
                              device="cpu")
    params["lora"]["layers"]["wq"]["lora_b"].fill_(0.25)
    checkpoints.save_adapter(str(tmp_path), params)
    got, _, gcfg, _ = cli.build_model(_cli_args(checkpoint=str(tmp_path),
                                                quantize="int4"))
    assert gcfg.lora.r == cfg.lora.r and gcfg.lora.scaling == cfg.lora.scaling
    assert torch.equal(got["lora"]["layers"]["wq"]["lora_b"],
                       params["lora"]["layers"]["wq"]["lora_b"])
    assert torch.equal(got["connector"]["fc2"]["w"],
                       params["connector"]["fc2"]["w"])
    assert "q4c" in got["llama"]["layers"]["w_gate"]


def test_engine_load_video_reads_feature_files(tmp_path):
    """load_video reads feature files through data/video_io (as the JAX
    engine does); a container it cannot decode says so."""
    from videollm_online_tpu_torch.data.video_io import read_video_frames

    def _load_features(path):
        return read_video_frames(path)

    feats = np.random.RandomState(0).randn(3, 10, 8).astype(np.float32)
    np.save(tmp_path / "a.npy", feats)
    np.savez(tmp_path / "a.npz", feats)
    torch.save(torch.from_numpy(feats).to(torch.bfloat16), tmp_path / "a.pt")
    np.testing.assert_array_equal(_load_features(str(tmp_path / "a.npy")),
                                  feats)
    np.testing.assert_array_equal(_load_features(str(tmp_path / "a.npz")),
                                  feats)
    np.testing.assert_array_equal(
        _load_features(str(tmp_path / "a.pt")),
        torch.from_numpy(feats).to(torch.bfloat16).float().numpy())
    from videollm_online_tpu_torch.data import video_io
    old, video_io._FFMPEG = video_io._FFMPEG, ""
    try:
        with pytest.raises(RuntimeError, match="ffmpeg"):
            _load_features("clip.mp4")
    finally:
        video_io._FFMPEG = old
