"""Ring and Ulysses sequence-parallel attention against the JAX package's.

The same global q/k/v and output cotangent (numpy, from a seed) go
through the JAX ``ring_attention`` / ``ulysses_attention`` on the CPU
mesh of ``tests/conftest.py`` (model axis of 2 or 4 devices, ``jax.grad``
through the shard_map) and through the port's on 2 or 4 ``gloo`` ranks
(``tests/_torch_dist.py``; each rank holds its T/N block and the gradients
flow through the ring shift or the all-to-alls). The ranks' blocks joined
along T must equal JAX's outputs and gradients within 2e-5 absolute, fp32
(two sums in another order: the online softmax's blocks, the products'
dot lengths). One world a size runs every case.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch

from videollm_online_tpu.ops.ring_attention import (
    make_ring_attn as jax_make_ring, ring_attention as jax_ring)
from videollm_online_tpu.ops.ulysses_attention import (
    ulysses_attention as jax_ulysses)

from videollm_online_tpu_torch.ops.ring_attention import make_ring_attn
from videollm_online_tpu_torch.ops.ulysses_attention import make_ulysses_attn
from videollm_online_tpu_torch.parallel.mesh import single_device_mesh

import _torch_parallel_workers as workers
from _torch_dist import start_worlds

ATOL = 2e-5
B, H, T, D = 2, 4, 16, 8
CASES = [(impl, causal) for impl in ("ring", "ulysses")
         for causal in (True, False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, heads=H):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, heads, T, D).astype(np.float32) for _ in range(4)]


def _jax(impl, causal, n, q, k, v, cot):
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(1, n),
                ("data", "model"))
    fn = jax_ring if impl == "ring" else jax_ulysses

    @jax.jit
    def out_and_grads(q, k, v, cot):
        out, vjp = jax.vjp(lambda q, k, v: fn(
            q, k, v, mesh=mesh, axis_name="model", causal=causal), q, k, v)
        return (out,) + vjp(cot)

    return [np.asarray(a) for a in out_and_grads(
        *(jnp.asarray(a) for a in (q, k, v, cot)))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world size: (the cases' inputs, every rank's results)}; the last
    case of world 4 is Ulysses on 2 heads (the head-poor refusal)."""
    cases = {}
    for n in (2, 4):
        cases[n] = [(impl, causal, *_inputs(10 * n + i))
                    for i, (impl, causal) in enumerate(CASES)]
    cases[4].append(("ulysses", True, *_inputs(99, heads=2)))
    results = start_worlds([(workers.sp_attention, n, (cases[n],))
                            for n in (2, 4)], tmp_path_factory.mktemp("sp"))()
    return {n: (cases[n], r) for n, r in zip((2, 4), results)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl,causal", CASES)
def test_outputs_and_gradients_equal_jax(worlds, n, impl, causal):
    cases, results = worlds[n]
    i = CASES.index((impl, causal))
    want = _jax(impl, causal, n, *cases[i][2:])
    blocks = [results[r][i] for r in range(n)]
    assert all(status == "ok" for status, _ in blocks)
    for j, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([b[1][j] for b in blocks], axis=2)
        np.testing.assert_allclose(got, want[j], rtol=0, atol=ATOL,
                                   err_msg=name)


def test_ulysses_refuses_head_poor_shapes(worlds):
    _, results = worlds[4]
    for r in range(4):
        status, msg = results[r][-1]
        assert status == "refused" and "use ops.ring_attention" in msg


def test_adapters_bind_the_sequence_axis_and_route_decode_shapes():
    """``make_*_attn`` mark the model axis as the sequence's (the forward
    then keeps T/N positions a rank), refuse a window, and send
    cache-decode shapes (queries shorter than the keys) to the
    single-device dispatch, as the JAX adapters do."""
    mesh = single_device_mesh(device="cpu")
    rng = np.random.RandomState(0)
    q = rng.randn(1, 4, 3, 8).astype(np.float32)
    k = rng.randn(1, 2, 10, 8).astype(np.float32)
    v = rng.randn(1, 2, 10, 8).astype(np.float32)
    pos = np.array([[7, 8, 9]], np.int32)
    jmesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                 ("data", "model"))
    want = np.asarray(jax_make_ring(jmesh, "model")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        None, num_groups=2))
    for make in (make_ring_attn, make_ulysses_attn):
        impl = make(mesh, "model")
        assert impl.sequence_axis == "model"
        got = impl(*(torch.from_numpy(a) for a in (q, k, v, pos)), None,
                   num_groups=2)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        with pytest.raises(AssertionError, match="sliding window"):
            impl(*(torch.from_numpy(a) for a in (q, k, v, pos)), None,
                 num_groups=2, sliding_window=4)
