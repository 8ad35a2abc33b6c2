"""Flash attention (K2): the port's plain forward and backward against the
JAX ``flash_attention``, run as the JAX package's own tests run it on the
CPU (Pallas interpret mode), and the dispatch rule of ``ops/auto.py``.

fp32 throughout. Tolerances are those of ``tests/test_pallas_kernels.py``:
out and lse atol 2e-5 / rtol 2e-4 (blockwise online softmax against one
pass), gradients atol 5e-4 / rtol 5e-3 (sums over up to G * T products in
another order). The CUDA kernels run only on a card:
``tests/test_torch_cuda.py`` holds them against these plain versions there.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.ops import flash_attention as jax_fa

from videollm_online_tpu_torch.models.llama import _attention
from videollm_online_tpu_torch.ops import auto
from videollm_online_tpu_torch.ops import flash_attention as fa

FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)

# (B, Hq, Hkv, T, S, d, q_offset, window, kv_valid)
CASES = {
    "gqa_4_2_T256_d64": (1, 4, 2, 256, 256, 64, 0, None, None),
    "mha_4_4_T128_d128": (2, 4, 4, 128, 128, 128, 0, None, None),
    "offset_128_S384": (1, 4, 2, 128, 384, 64, 128, None, None),
    "window_128": (1, 4, 2, 384, 384, 64, 0, 128, None),
    "kv_valid_200": (1, 4, 2, 256, 256, 64, 0, None, 200),
}


def _inputs(B, Hq, Hkv, T, S, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, T, d).astype(np.float32),
            rng.randn(B, Hkv, S, d).astype(np.float32),
            rng.randn(B, Hkv, S, d).astype(np.float32),
            rng.randn(B, Hq, T, d).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_and_backward_match_jax(case):
    B, Hq, Hkv, T, S, d, off, window, kv_valid = CASES[case]
    q, k, v, do = _inputs(B, Hq, Hkv, T, S, d, seed=len(case))
    scale = 1.0 / d ** 0.5
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_out, want_lse = jax_fa._flash_fwd(
        jq, jk, jv, scale=scale, causal=True, q_offset=off, block_q=512,
        block_k=512, window=window, kv_valid=kv_valid)
    _, vjp = jax.vjp(lambda a, b, c: jax_fa.flash_attention(
        a, b, c, scale, True, off, 512, 512, window, kv_valid), jq, jk, jv)
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = fa.flash_attention_fwd_reference(
        tq.detach(), tk.detach(), tv.detach(), scale, True, off, window,
        kv_valid)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               **FWD_TOL)
    got = fa.flash_attention(tq, tk, tv, scale, True, off, window, kv_valid)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_out),
                               **FWD_TOL)
    got.backward(torch.from_numpy(do))
    for t, w, name in zip((tq, tk, tv), want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD_TOL)
    ref = fa.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), out, lse, torch.from_numpy(do),
        scale, True, off, window, kv_valid)
    for t, w, name in zip(ref, want_grads, "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                   err_msg=f"bwd reference d{name}",
                                   **GRAD_TOL)


def test_autograd_matches_plain_attention_gradients():
    """The autograd function's gradients equal PyTorch autograd through the
    decoder's plain ``_attention`` on the training shape (positions
    0..T-1)."""
    B, Hq, Hkv, T, d = 1, 4, 2, 128, 64
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(B, Hq, Hkv, T, T, d, seed=9))
    grads = []
    for fn in ("flash", "plain"):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if fn == "flash":
            out = fa.flash_attention(*leaves, 1.0 / d ** 0.5)
        else:
            pos = torch.arange(T, dtype=torch.int32)[None]
            out = _attention(*leaves, pos, None, num_groups=Hq // Hkv)
        out.backward(do)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 64, 64, 64, 3))
    before = (fa.flash_fwd.launches, fa.flash_dkdv.launches,
              fa.flash_dq.launches)
    out, lse = fa.flash_fwd(q, k, v, 0.125)
    delta = fa.softmax_delta(do, out)
    dk, dv = fa.flash_dkdv(q, k, v, do, lse, delta, 0.125)
    dq = fa.flash_dq(q, k, v, do, lse, delta, 0.125)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, 0.125)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b)
    assert (fa.flash_fwd.launches, fa.flash_dkdv.launches,
            fa.flash_dq.launches) == before


def _fake(shape, cuda=True):
    return SimpleNamespace(shape=shape, is_cuda=cuda)


@pytest.mark.parametrize("T,S,d,int8,want", [
    (4096, 4096, 128, False, "flash"),   # the 8B training shape
    (256, 256, 64, False, "flash"),
    (128, 128, 256, False, "flash"),
    (200, 200, 128, False, "plain"),     # T % 128 != 0, too long for K1
    (64, 64, 128, False, "decode"),      # T % 128 != 0, short: K1
    (128, 384, 128, False, "plain"),     # T != S: a cache append
    (128, 128, 128, True, "plain"),      # int8 K/V never go to K2
    (20, 8192, 128, False, "decode"),
    (256, 256, 32, False, "plain"),      # head size the kernels lack
])
def test_route_follows_the_jax_dispatch_rule(T, S, d, int8, want):
    """ops/auto.py:36-44 of the JAX package on its TPU: flash for
    k_scale None, T == S, T % 128 == 0 and d in (64, 128, 256), checked
    before the decode rule; the plain path for any CPU tensor."""
    q, k = _fake((1, 32, T, d)), _fake((1, 8, S, d))
    assert auto.route(q, k, object() if int8 else None) == want
    assert auto.route(_fake((1, 32, T, d), cuda=False), k) == "plain"


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor cores"),
    (torch.bfloat16, 128, "tensor cores"),
    (torch.bfloat16, 256, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_kernel_design_by_dtype_and_head_size(dtype, d, want):
    """bf16 with d <= 128 runs on the tensor cores (wgmma for the forward,
    dK/dV and dQ); fp32 and bf16 d = 256 on FMA. The code
    passed to the library is the design's index in DESIGNS."""
    assert fa.kernel_design(dtype, d) == want
    assert fa.DESIGNS.index(want) == (1 if want == "tensor cores" else 0)


# (T, S, q_offset, window, kv_len): the training shape cut down, ragged T,
# q_offset not a multiple of a tile, windows, kv_valid, a row that sees
# nothing (window 8 past kv_valid 40)
SCHEDULE_CASES = [
    (512, 512, 0, None, 512),
    (1000, 1000, 0, None, 1000),
    (256, 456, 200, None, 456),
    (200, 456, 256, None, 456),
    (384, 384, 0, 100, 300),
    (640, 640, 0, 256, 640),
    (1024, 1024, 0, None, 900),
    (128, 128, 0, 8, 40),
]


@pytest.mark.parametrize("kernel", ["fwd", "dkdv", "dq"])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_schedule_computes_every_visible_pair_and_no_dead_block(kernel,
                                                                case):
    """The tensor-core kernels' schedule (the tile ranges each CTA walks,
    the blocks each dK/dV or dQ consumer skips) computes every visible
    (row, col) pair, and every block it computes holds a visible pair: a
    forward CTA's 128 x 128 tile, a dK/dV or dQ consumer's 64 x 64
    block."""
    T, S, off, window, kv_len = case
    done = fa.computed_pairs(kernel, T, S, off, True, window, kv_len)
    vis = fa.visible_mask(T, S, off, True, window, kv_len, "cpu")
    assert not bool((vis & ~done).any())
    bm, bn = fa.FWD_TILE if kernel == "fwd" else (64, 64)
    for r0 in range(0, T, bm):
        for c0 in range(0, S, bn):
            if bool(done[r0:r0 + bm, c0:c0 + bn].any()):
                assert bool(vis[r0:r0 + bm, c0:c0 + bn].any()), (r0, c0)


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_tile_ranges_are_the_tiles_with_a_visible_pair(case):
    """kv_tile_range (per 128-row q tile, against kv tiles of 128 for the
    forward and of 64 for dQ) and q_tile_range (per 128-row k
    tile, 64-row q tiles) return exactly the tiles that hold a visible
    pair; an empty range where none does."""
    T, S, off, window, kv_len = case
    vis = fa.visible_mask(T, S, off, True, window, kv_len, "cpu")
    dbm, dbn = fa.DKDV_TILE
    for tile in (fa.FWD_TILE, fa.DQ_TILE):
        fbm, fbn = tile
        for q0 in range(0, T, fbm):
            want = [c // fbn for c in range(0, S, fbn)
                    if bool(vis[q0:q0 + fbm, c:c + fbn].any())]
            first, last = fa.kv_tile_range(q0, T, kv_len, off, True, window,
                                           tile)
            assert list(range(first, last + 1)) == want, (tile, q0)
    for k0 in range(0, S, dbn):
        want = [r // dbm for r in range(0, T, dbm)
                if bool(vis[r:r + dbm, k0:k0 + dbn].any())]
        first, last = fa.q_tile_range(k0, T, kv_len, off, True, window)
        assert list(range(first, last + 1)) == want, k0


def test_check_refuses_rows_past_32_bit_coordinates():
    """B * heads * rows at 2^31 or more would overflow the kernels' 32-bit
    TMA coordinates: refused before any launch (meta tensors, no memory)."""
    q = torch.empty((2, 32, 2 ** 25, 64), device="meta")
    k = torch.empty((2, 8, 2 ** 25, 64), device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        fa._check(q, k, k, 0, None, None)
