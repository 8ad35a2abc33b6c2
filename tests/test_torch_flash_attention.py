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
