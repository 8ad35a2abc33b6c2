"""The port's paged KV cache, int8 KV and K3's plain version against the JAX
package.

Same inputs, made from a seed with numpy, through the JAX function and its
counterpart in the port:
  * K3's plain version (``paged_attention_reference``, what the port's
    dispatch takes on the CPU) against the JAX Pallas kernel in interpret
    mode and the JAX gather reference, on the cases of
    ``tests/test_paged.py``: atol 2e-5, rtol 2e-4 (the JAX test's own
    tolerance for kernel against reference); in bf16 (bf16 q over bf16 or
    int8 pools) at the bounds of BF16_KERNEL_TOL;
  * the kernels' schedule over pages of 32, 64 and 512 slots, as the
    wrappers mirror it (``split_ranges``, ``tile_rows``);
  * ``quantize_kv``: codes and scales bit-identical;
  * paged appends: the pools after the append sequences of
    ``tests/test_paged.py`` bit-identical to the JAX ``_paged_append``'s on
    every page but the trash page 0, for the same stored values;
  * the decoder over a paged, an int8 paged and an int8 ring cache: logits
    at every append within the JAX tests' atol 3e-5, rtol 3e-4 (fp32), and
    the ring compaction bit-identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from videollm_online_tpu.core.config import tiny_live_config as jax_tiny_cfg
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.models import llama as jax_llama
from videollm_online_tpu.ops.paged_attention import (
    paged_attention_reference as jax_paged_reference,
    paged_decode_attention as jax_paged_kernel)

from videollm_online_tpu_torch.core.config import tiny_live_config
from videollm_online_tpu_torch.models import llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.ops import paged_attention as pa

from _torch_schedule import SCHEDULE_S, check_schedule

KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)
LOGIT_TOL = dict(atol=3e-5, rtol=3e-4)
# bf16: the plain version, like the JAX gather reference, keeps P in fp32;
# the Pallas kernel (and the CUDA kernel) round P to bf16 before P.V. The
# plain version against the gather reference holds at KERNEL_TOL (both
# fp32 inside; readings 3.8e-6); against the Pallas kernel at this bound,
# elementwise (atol at rtol 2e-2) and on the relative norm error, above
# the readings on these inputs (median |want| 0.18 to 0.23): max error
# 7.8e-3, atol needed 1.1e-3, relative norm 2.7e-3.
BF16_KERNEL_TOL = dict(atol=2e-3, rtol=2e-2, rel=4e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attention_case(seed, quantized):
    """tests/test_paged.py's kernel cases: 2 streams, 2 layers, pages of
    32 slots, a shuffled table, stream 0 crossing pages, stream 1 short."""
    rng = np.random.RandomState(seed)
    B, Hq, Hkv, S, d, page, maxp = 2, 4, 2, 3, 16, 32, 4
    P = 1 + B * maxp
    q = rng.randn(B, Hq, S, d).astype(np.float32)
    pool_k = rng.randn(2, P, Hkv, page, d).astype(np.float32)
    pool_v = rng.randn(2, P, Hkv, page, d).astype(np.float32)
    scales = (None, None)
    if quantized:
        (kq, ks), (vq, vs) = (jax_llama.quantize_kv(jnp.asarray(x))
                              for x in (pool_k, pool_v))
        pool_k, pool_v = np.array(kq), np.array(vq)
        scales = (np.array(ks), np.array(vs))
    perm = rng.permutation(P - 1) + 1
    table = perm[:B * maxp].reshape(B, maxp).astype(np.int32)
    q_pos = np.asarray([[70, 71, 72], [5, 6, 7]], np.int32)
    return q, pool_k, pool_v, scales, table, q_pos


@pytest.mark.parametrize("kind,layer,window", [
    (kind, layer, window) for kind in ("f32", "int8")
    for layer in (0, 1) for window in (None, 40)] + [
    ("bf16", 1, None), ("bf16", 0, 40), ("bf16_int8", 1, 40)])
def test_plain_k3_matches_jax_kernel_and_reference(kind, layer, window):
    quantized, bf16 = "int8" in kind, kind.startswith("bf16")
    q, pk, pv, (ks, vs), table, q_pos = _attention_case(
        7 if quantized else 0, quantized)
    jargs = [jnp.asarray(x) for x in (q, pk, pv, table, q_pos)]
    targs = [torch.from_numpy(x) for x in (q, pk, pv, table, q_pos)]
    if bf16:       # q and float pools in bf16; int8 codes and scales as they are
        jargs[:3] = [x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
                     for x in jargs[:3]]
        targs[:3] = [x.to(torch.bfloat16) if x.is_floating_point() else x
                     for x in targs[:3]]
    jsc = {} if ks is None else {"k_scale": jnp.asarray(ks),
                                 "v_scale": jnp.asarray(vs)}
    jax_ref = jax_paged_reference(*jargs, layer, window=window, **jsc)
    jax_kernel = jax_paged_kernel(*jargs, layer, window=window,
                                  interpret=True, **jsc)
    tsc = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                 "v_scale": torch.from_numpy(vs)}
    got = pa.paged_attention(*targs, layer, window=window, **tsc)
    assert got.dtype == targs[0].dtype
    f32 = np.asarray(got.float().numpy())
    np.testing.assert_allclose(f32, np.asarray(jax_ref.astype(jnp.float32)),
                               **KERNEL_TOL)
    want = np.asarray(jax_kernel.astype(jnp.float32))
    if bf16:
        tol = BF16_KERNEL_TOL
        np.testing.assert_allclose(f32, want, atol=tol["atol"],
                                   rtol=tol["rtol"])
        assert np.linalg.norm(f32 - want) / np.linalg.norm(want) <= tol["rel"]
    else:
        np.testing.assert_allclose(f32, want, **KERNEL_TOL)
    assert torch.equal(got, pa.paged_decode_attention(
        *targs, layer, window=window, **tsc))   # the CPU wrapper's route


def test_plain_k3_row_with_nothing_visible_is_zero():
    """A row that sees no slot outputs 0, as the kernel's does (the JAX
    gather reference averages every slot there: a documented divergence
    the engine never reaches)."""
    q, pk, pv, _, table, q_pos = _attention_case(0, False)
    q_pos = np.asarray([[70, 71, 72], [-1, 6, 7]], np.int32)
    got = pa.paged_attention_reference(
        *[torch.from_numpy(x) for x in (q, pk, pv, table, q_pos)], 0,
        window=None)
    assert torch.count_nonzero(got[1, :, 0]) == 0
    assert torch.count_nonzero(got[1, :, 1:]) > 0


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 16).astype(np.float32) * rng.uniform(
        0.01, 10.0, (2, 3, 5, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 0
    x[1, 2, 4, 3] = 1e-20                  # below the 1e-12 floor
    if dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jcodes, jscale = jax_llama.quantize_kv(jx)
    codes, scale = llama.quantize_kv(tx)
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy().view(np.int32),
                                  np.asarray(jscale).view(np.int32))


def _identity_table(B, maxp):
    return (1 + np.arange(B)[:, None] * maxp
            + np.arange(maxp)[None]).astype(np.int32)


def _junk_table():
    table = np.zeros((2, 4), np.int32)
    table[0, 0] = 1                       # stream 0 owns logical page 0 only
    table[1, :2] = [2, 3]
    return table


# tests/test_paged.py's append sequences: (table, [(S, num_valid)])
APPENDS = {
    "across_appends": (_identity_table(2, 6), [
        (S, (S, max(S - 2, 1))) for S in (24, 24, 11, 11, 1, 1, 30, 1)]),
    "junk_into_trash": (_junk_table(), [(40, (20, 40)), (24, (8, 0))]),
}


@pytest.mark.parametrize("scale_pool", [False, True], ids=["kv", "scales"])
@pytest.mark.parametrize("name", list(APPENDS))
def test_paged_append_pools_equal_jax(name, scale_pool):
    table, steps = APPENDS[name]
    B, maxp = table.shape
    page, Hkv, hd, L = 32, 2, 16, 2
    P = 1 + B * maxp
    shape = (L, P, Hkv, page) + (() if scale_pool else (hd,))
    rng = np.random.RandomState(5)
    jpool = jnp.zeros(shape, jnp.float32)
    pool = torch.zeros(shape)
    offset = np.zeros((B,), np.int32)
    for S, nv in steps:
        for layer in range(L):
            store = rng.randn(*((B, Hkv, S) + shape[4:])).astype(np.float32)
            jpool = jax_llama._paged_append(
                jpool, jnp.int32(layer), jnp.asarray(table),
                jnp.asarray(offset), jnp.asarray(store))
            phys, row = llama.paged_slots(
                torch.from_numpy(table), torch.from_numpy(offset), page, S,
                torch.tensor(nv))
            llama.paged_append(pool, layer, phys, row,
                               torch.from_numpy(store))
        offset = offset + np.asarray(nv, np.int32)
        np.testing.assert_array_equal(pool[:, 1:].numpy(),
                                      np.asarray(jpool)[:, 1:])


def test_paged_append_past_the_table_raises():
    table = torch.from_numpy(_identity_table(1, 2))
    with pytest.raises(ValueError, match="past the page table"):
        llama.paged_slots(table, torch.tensor([60]), 32, 8, torch.tensor([5]))
    # padding past the table lands on the trash page
    phys, row = llama.paged_slots(table, torch.tensor([60]), 32, 8,
                                  torch.tensor([4]))
    assert phys.tolist() == [2] * 4 + [0] * 4
    assert row.tolist() == [28, 29, 30, 31, 0, 1, 2, 3]


def _caches(kind, jcfg, cfg, B, page, maxp):
    """(jax cache, port cache) of one kind: "paged", "paged_int8" (identity
    tables) or "ring_int8"."""
    if kind == "ring_int8":
        return (jax_llama.init_kv_cache(jcfg.llama, batch=B,
                                        capacity=page * maxp, quant="int8"),
                llama.init_kv_cache(cfg.llama, batch=B, capacity=page * maxp,
                                    quant="int8", device="cpu"))
    quant = "int8" if kind == "paged_int8" else None
    kw = dict(batch=B, pool_pages=1 + B * maxp, pages_per_stream=maxp,
              page_size=page, quant=quant)
    jc = jax_llama.init_paged_kv_cache(jcfg.llama, dtype=jnp.float32, **kw)
    tc = llama.init_paged_kv_cache(cfg.llama, device="cpu", **kw)
    table = _identity_table(B, maxp)
    return (jc._replace(table=jnp.asarray(table)),
            tc.replace(table=torch.from_numpy(table)))


@pytest.fixture(scope="module")
def tiny_decoder():
    """The tiny config's weights in both packages and the jitted JAX
    forward, built once for the module's forward cases."""
    jcfg, cfg = jax_tiny_cfg(), tiny_live_config()
    jparams = jax.device_get(jax_live.init_params(jax.random.PRNGKey(0),
                                                  jcfg))["llama"]
    return (jcfg, cfg, jparams, params_from_numpy(jparams, device="cpu"),
            jax.jit(jax_llama.forward, static_argnames=("cfg",)))


@pytest.mark.parametrize("kind", ["paged", "paged_int8", "ring_int8"])
def test_forward_logits_match_jax(kind, tiny_decoder):
    """tests/test_paged.py's decoder sequence (prefill, page-crossing
    appends, 1-token decodes, ragged validity) through both packages."""
    jcfg, cfg, jparams, params, jforward = tiny_decoder
    jcache, cache = _caches(kind, jcfg, cfg, 2, 32, 6)
    rng = np.random.RandomState(5 if "int8" in kind else 1)
    for S in (24, 24, 11, 11, 1, 1, 30, 1):
        ids = rng.randint(0, cfg.llama.vocab_size, (2, S))
        nv = np.asarray([S, max(S - 2, 1)], np.int32)
        want, jcache = jforward(
            jparams, cfg=jcfg.llama, input_ids=jnp.asarray(ids),
            kv_cache=jcache, num_valid=jnp.asarray(nv))
        got, cache = llama.forward(
            params, cfg=cfg.llama, input_ids=torch.from_numpy(ids),
            kv_cache=cache, num_valid=torch.from_numpy(nv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"append S={S}", **LOGIT_TOL)
        np.testing.assert_array_equal(cache.offset.numpy(),
                                      np.asarray(jcache.offset))
    if "int8" in kind:
        # nearly every code equal (a code may sit at a rounding boundary
        # that the two packages' fp32 K/V straddle)
        same = (cache.k.numpy() == np.asarray(jcache.k)).mean()
        assert same > 0.999


def test_compact_kv_cache_equal_jax():
    rng = np.random.RandomState(9)
    L, B, Hkv, C, hd = 2, 3, 2, 16, 4
    k, v = (rng.randn(L, B, Hkv, C, hd).astype(np.float32) for _ in range(2))
    ks, vs = (rng.rand(L, B, Hkv, C).astype(np.float32) for _ in range(2))
    offset = np.asarray([12, 3, 9], np.int32)
    pos_base = np.asarray([0, 5, 2], np.int32)
    jc = jax_llama.KVCache(*(jnp.asarray(x) for x in (k, v, offset, pos_base,
                                                      ks, vs)))
    tc = llama.KVCache(*(torch.from_numpy(x.copy()) for x in (
        k, v, offset, pos_base, ks, vs)))
    want = jax_llama.compact_kv_cache(jc, 6)
    got = llama.compact_kv_cache(tc, 6)
    for name in ("k", "v", "offset", "pos_base", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_dispatch_takes_the_plain_version_on_the_cpu():
    q, pk, pv, _, table, q_pos = _attention_case(0, False)
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, q_pos)]
    pa.paged_decode_attention.launches = 0
    out = pa.paged_attention(*args, 1, window=None)
    assert pa.paged_decode_attention.launches == 0
    assert torch.equal(out, pa.paged_attention_reference(*args, 1))


@pytest.mark.parametrize("kind", ["paged", "ring_int8"])
def test_decode_graph_refuses_what_it_cannot_replay(kind, tiny_decoder):
    """A decode graph replays a paged-cache forward on a CUDA device only:
    on the CPU, and over the ring, the forward refuses the holder before it
    writes anything, and the holder has captured nothing."""
    jcfg, cfg, _, params, _ = tiny_decoder
    _, cache = _caches(kind, jcfg, cfg, 2, 32, 6)
    k0 = cache.k.clone()
    graph = llama.DecodeGraph()
    with pytest.raises(ValueError, match="decode graph"):
        llama.forward(params, cfg=cfg.llama,
                      input_ids=torch.ones((2, 1), dtype=torch.long),
                      kv_cache=cache, decode_graph=graph)
    assert torch.equal(cache.k, k0)
    assert graph.captures == graph.replays == 0 and graph.post_out is None


@pytest.mark.parametrize("design", pa.DESIGNS)
@pytest.mark.parametrize("page", [32, 64, 512])
def test_schedule_over_pages(design, page):
    """K3's schedule as ops/paged_attention.py mirrors the CUDA source, at
    S 1 / 7 / 20 / 21 / 64 / 91 / 128 with ragged offsets and windows off
    and on: the splits cover each stream's visible tiles exactly once (none
    past its last visible slot or wholly below its window); every loaded
    row of a tile is the table's page and row for its slot, read through
    one lookup a tile when the page holds whole tiles (page % 64 == 0 on
    the tensor cores); rows outside the visible slots and pages outside
    them (the trash page 0 past a stream's end) are never touched."""
    maxp = -(-2600 // page)
    slots = maxp * page
    rng = np.random.RandomState(page)
    table = list(rng.permutation(4 * maxp)[:maxp] + 1)
    bk = pa.BLOCK_K[design]
    for S in SCHEDULE_S:
        nsplit = pa.num_splits(design, 132, 8, 8, 4 * S, slots)
        for window in (None, 100, 700):
            for off in (-S, 0, 31, 100, 448, 511, 1000, 2431):
                q_pos = [off + i for i in range(S)]
                check_schedule(design, q_pos, window, slots, nsplit)
                lo, hi = pa.visible_slots(q_pos, window, slots)
                last_page = hi // page if hi >= 0 else -1
                tab = table[:last_page + 1] + [0] * (maxp - last_page - 1)
                for start, end in pa.split_ranges(design, q_pos, window,
                                                  slots, nsplit):
                    for tile in range(start, end):
                        rows = pa.tile_rows(tab, page, tile * bk, lo, hi,
                                            design)
                        for r, got in enumerate(rows):
                            slot = tile * bk + r
                            if not lo <= slot <= hi:
                                assert got is None
                                continue
                            assert got == (tab[slot // page], slot % page)
                            assert got[0] != 0       # never the trash page
