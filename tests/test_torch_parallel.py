"""The port's mesh, partition rules, rank-local shards and collectives.

``param_specs`` is held to the JAX package's ``param_specs`` leaf for leaf;
``shard_params`` is held to its inverse: every rank's shards of a tree
(plain, int8, column-packed and row-packed int4, kv replication at
model=4) joined again give back each logical matrix exactly. The
rank-local trees are cut with a stand-in mesh that has only a shape and a
coordinate (no process group is needed to cut). The collectives run in
one ``gloo`` world of 4 on the CPU (``tests/_torch_dist.py``), each
forward and backward held to its formula exactly.
"""

import numpy as np
import pytest

import jax

import torch

from videollm_online_tpu.core.config import LiveConfig as JaxLiveConfig
from videollm_online_tpu.core.config import LlamaConfig as JaxLlamaConfig
from videollm_online_tpu.core.config import LoraConfig as JaxLoraConfig
from videollm_online_tpu.core.config import tiny_vision_config as jax_vision
from videollm_online_tpu.models import live as jax_live
from videollm_online_tpu.parallel import sharding as jax_shd

from videollm_online_tpu_torch.core.config import (LlamaConfig,
                                                   tiny_live_config)
from videollm_online_tpu_torch.models import llama
from videollm_online_tpu_torch.models.bridge import params_from_numpy
from videollm_online_tpu_torch.models.quant import (
    dequantize_weight, quantize_llama_params, quantize_weight_int4)
from videollm_online_tpu_torch.parallel import mesh as mesh_mod
from videollm_online_tpu_torch.parallel import sharding as shd
from videollm_online_tpu_torch.train import step

import _torch_parallel_workers as workers
from _torch_dist import run_world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Coords:
    """A mesh's shape and one rank's coordinates, without a group."""

    def __init__(self, data, model, d, m):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self._c = {"data": d, "model": m}

    def coord(self, axis):
        return self._c[axis]


def _jax_tree():
    cfg = JaxLiveConfig(
        llama=JaxLlamaConfig(vocab_size=512, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=16,
                             dtype="float32"),
        vision=jax_vision(), lora=JaxLoraConfig(r=4, alpha=8),
        vision_hidden_size=32, max_num_frames=64)
    return jax.device_get(jax_live.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_param_specs_equal_jax(policy):
    jparams = _jax_tree()
    want = jax_shd.param_specs(jparams, policy)
    got = shd.param_specs(params_from_numpy(jparams, device="cpu"), policy)
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(flat_w) > 10
    for path, spec in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        assert node == tuple(spec), (path, node, spec)
    assert shd.batch_spec() == tuple(jax_shd.batch_spec())
    assert shd.kv_cache_spec() == tuple(jax_shd.kv_cache_spec())


def _cfg(**kw):
    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                dtype="float32")
    base.update(kw)
    return LlamaConfig(**base)


def _tree(cfg, bits):
    p = llama.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return p if bits is None else quantize_llama_params(p, bits=bits)


def _join(parts_by_rank, data, model, cfg, policy):
    """Join every rank's shard of each matrix back (data axis innermost
    first, then the model axis)."""
    out = {}

    def leaf(tree, name):
        return tree["layers"][name] if name in shd.MATRICES else tree[name]

    for name in list(shd.MATRICES) + ["embed", "lm_head"]:
        spec = shd._spec_for_path(
            ("layers/" if name in shd.MATRICES else "") + name, policy,
            3 if name in shd.MATRICES else 2)
        dims = {a: d for d, a in enumerate(spec) if a is not None}
        row = name == "embed"
        per_model = []
        for m in range(model):
            pieces = [leaf(parts_by_rank[(d, m)], name) for d in range(data)]
            per_model.append(
                shd.merge_matrix(pieces, dims["data"], row_scaled=row)
                if "data" in dims and data > 1 else pieces[0])
        if "model" in dims and model > 1:
            if name in ("wk", "wv") and model > cfg.num_kv_heads:
                # kv replication: rank h * model / Hkv holds kv head h first
                per_model = [per_model[h * model // cfg.num_kv_heads]
                             for h in range(cfg.num_kv_heads)]
            out[name] = shd.merge_matrix(per_model, dims["model"],
                                         row_scaled=row)
        else:
            out[name] = per_model[0]
    return out


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("data,model,policy,bits", [
    (1, 2, "tp", None), (1, 2, "tp", 8), (1, 2, "tp", 4),
    (1, 4, "tp", None), (1, 4, "tp", 8),
    (2, 2, "fsdp_tp", None), (2, 2, "fsdp_tp", 8), (2, 2, "fsdp_tp", 4),
])
def test_shards_join_back_to_every_matrix(data, model, policy, bits):
    cfg = _cfg()
    tree = _tree(cfg, bits)
    parts = {(d, m): step.shard_params(tree, _Coords(data, model, d, m),
                                       policy, cfg=cfg)
             for d in range(data) for m in range(model)}
    joined = _join(parts, data, model, cfg, policy)
    for name, leaf in joined.items():
        want = tree["layers"][name] if name in shd.MATRICES else tree[name]
        _equal(leaf, want)
    # a rank holds its own block: the q heads' columns, and at model=4
    # (over 2 kv heads) the one kv head its query heads read
    for (d, m), p in parts.items():
        q_cols = shd.logical_shape(p["layers"]["wq"])[-1]
        kv_cols = shd.logical_shape(p["layers"]["wk"])[-1]
        assert q_cols == cfg.q_dim // model
        assert kv_cols == max(cfg.num_kv_heads // model, 1) * cfg.head_dim
        assert p["final_norm"] is tree["final_norm"]


def test_shard_params_cuts_only_the_axes_given():
    """``axes=("data",)`` (the trainer's choice under a sequence-parallel
    attention) leaves every matrix whole along the model axis."""
    cfg = _cfg()
    tree = _tree(cfg, 8)
    both = step.shard_params(tree, _Coords(2, 2, 1, 1), "fsdp_tp", cfg=cfg)
    data = step.shard_params(tree, _Coords(2, 2, 1, 1), "fsdp_tp", cfg=cfg,
                             axes=("data",))
    for name in ("wq", "wo"):
        whole = shd.logical_shape(tree["layers"][name])
        assert shd.logical_shape(both["layers"][name]) == (
            whole[0], whole[1] // 2, whole[2] // 2)
    assert shd.logical_shape(data["layers"]["wq"]) == (2, 128, 256)
    assert torch.equal(data["layers"]["wq"]["q8"],
                       tree["layers"]["wq"]["q8"][:, 128:])


def test_sequence_parallel_refuses_a_tree_cut_along_the_model_axis():
    """Under a sequence-parallel attention the weights stay whole along
    the model axis; tensor parallel needs them cut along it."""
    from videollm_online_tpu_torch.parallel.context import ParallelContext
    cfg = _cfg()
    tree = _tree(cfg, 8)
    mesh = _Coords(2, 2, 0, 1)
    cut = step.shard_params(tree, mesh, "fsdp_tp", cfg=cfg)
    data_only = step.shard_params(tree, mesh, "fsdp_tp", cfg=cfg,
                                  axes=("data",))
    sp = ParallelContext(mesh, cfg, sequence_parallel=True)
    tp = ParallelContext(mesh, cfg)
    sp.check_sharded(data_only["layers"]["wq"])
    tp.check_sharded(cut["layers"]["wq"])
    with pytest.raises(ValueError, match="sequence parallel"):
        sp.check_sharded(cut["layers"]["wq"])
    with pytest.raises(ValueError, match="tensor parallel"):
        tp.check_sharded(data_only["layers"]["wq"])


def test_kv_replication_picks_the_heads_queries_read():
    cfg = _cfg()
    tree = _tree(cfg, None)
    wk = tree["layers"]["wk"]
    for m in range(4):
        p = step.shard_params(tree, _Coords(1, 4, 0, m), "tp", cfg=cfg)
        head = m * cfg.num_kv_heads // 4          # query heads m of 4 -> kv
        hd = cfg.head_dim
        assert torch.equal(p["layers"]["wk"],
                           wk[..., head * hd:(head + 1) * hd])
    assert shd.tp_ranges(cfg, 4, 3)["kv"] == (1 * 64, 64)
    with pytest.raises(ValueError, match="kv heads"):
        shd.tp_ranges(_cfg(num_heads=6, num_kv_heads=3), 2, 0)


def test_quantized_shards_are_valid_local_layouts():
    """A q4c column shard and a q4p row shard dequantize to the slice of
    the whole matrix's dequantization; an int8 row-parallel shard keeps
    the whole scale; an int4 group that would straddle two shards is
    refused."""
    cfg = _cfg()
    tree = _tree(cfg, 4)
    part = step.shard_params(tree, _Coords(1, 2, 0, 1), "tp", cfg=cfg)
    for name, dim, key in (("w_gate", -1, "f"), ("w_down", -2, "f")):
        whole = dequantize_weight(tree["layers"][name], dtype=torch.float32)
        s, c = shd.tp_ranges(cfg, 2, 1)[key]
        local = dequantize_weight(part["layers"][name], dtype=torch.float32)
        assert torch.equal(local, whole.narrow(dim, s, c))
    assert torch.equal(part["layers"]["wo"]["scale"],
                       tree["layers"]["wo"]["scale"])
    w = torch.randn(2, 512, 256)
    q4p = quantize_weight_int4(w)
    local = shd.shard_matrix(q4p, -2, 256, 256)
    assert torch.equal(dequantize_weight(local, dtype=torch.float32),
                       dequantize_weight(q4p, dtype=torch.float32)[:, 256:])
    with pytest.raises(ValueError, match="straddle"):
        shd.shard_matrix(q4p, -2, 64, 64)


def test_shard_batch_rules():
    ids = torch.arange(4 * 6).reshape(4, 6) % 7
    cfg = tiny_live_config().replace(v_placeholder_id=3)
    batch = {"input_ids": ids, "labels": ids + 1,
             "frames": torch.zeros(9, 2), "attention": None}
    for d in range(2):
        out = step.shard_batch(batch, _Coords(2, 2, d, 1), cfg=cfg)
        assert torch.equal(out["input_ids"], ids[2 * d:2 * d + 2])
        assert torch.equal(out["labels"], ids[2 * d:2 * d + 2] + 1)
        assert out["frames"] is batch["frames"]     # replicated
        assert out["attention"] is None
        v_before = int((ids[:2 * d] == 3).sum())
        assert out["shard"].tolist() == [2 * d, 4, v_before]
    # a batch the data axis does not divide stays whole on every rank
    out = step.shard_batch(batch, _Coords(3, 1, 2, 0), cfg=cfg)
    assert out["input_ids"] is ids and "shard" not in out
    # the accumulation axis: split dim 1, one shard row a microbatch
    acc = {"input_ids": ids.reshape(2, 2, 6), "labels": ids.reshape(2, 2, 6)}
    out = step.shard_batch(acc, _Coords(2, 1, 1, 0), accum_axis=True)
    assert torch.equal(out["input_ids"], ids.reshape(2, 2, 6)[:, 1:])
    assert out["shard"].tolist() == [[1, 2, 0], [1, 2, 0]]
    with pytest.raises(ValueError, match="<v>"):
        step.shard_batch(batch, _Coords(2, 1, 1, 0))


def test_make_mesh_errors_and_single_device():
    with pytest.raises(AssertionError, match="not divisible by model=2"):
        mesh_mod.make_mesh(model=2, device="cpu")
    with pytest.raises(AssertionError, match="mesh 3x1 != 1 devices"):
        mesh_mod.make_mesh(data=3, device="cpu")
    with pytest.raises(AssertionError, match="whole world"):
        mesh_mod.make_mesh(devices=[1], device="cpu")
    m = mesh_mod.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    s = mesh_mod.single_device_mesh(device="cpu")
    assert s.shape == m.shape and s.coord("model") == 0
    assert mesh_mod.current_mesh() is None
    with mesh_mod.maybe_mesh(s):
        assert mesh_mod.current_mesh() is s
        with mesh_mod.maybe_mesh(None):
            assert mesh_mod.current_mesh() is s
    assert mesh_mod.current_mesh() is None
    assert mesh_mod.choose_backend(2, "cpu") == "gloo"
    # the shard of a one-rank mesh is the tree itself
    tree = {"layers": {}}
    assert step.shard_params(tree, s) is tree


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    return run_world(workers.collectives, 4,
                     tmp_path_factory.mktemp("coll"))


def _x(rank, world=4):
    return (rank * 100 + np.arange(world * 6, dtype=np.float32)
            ).reshape(world * 2, 3)


@pytest.mark.parametrize("name", ["all_reduce", "all_gather", "all_to_all",
                                  "ring_shift"])
def test_collective_and_its_transpose(collective_results, name):
    W = 4
    xs = [_x(r) for r in range(W)]
    cots = [float(r + 1) for r in range(W)]
    for r, res in enumerate(collective_results):
        y, g = res[name]
        if name == "all_reduce":
            want_y = sum(xs)
            want_g = np.full_like(xs[r], sum(cots))
        elif name == "all_gather":
            want_y = np.concatenate(xs, axis=1)
            want_g = np.full_like(xs[r], sum(cots))   # reduce-scatter
        elif name == "all_to_all":
            # chunk r of every rank along dim 0, joined along dim 1
            want_y = np.concatenate([x[2 * r:2 * r + 2] for x in xs], axis=1)
            # the reverse all-to-all: row chunk j came back from rank j
            want_g = np.concatenate(
                [np.full((2, 3), cots[j], np.float32) for j in range(W)])
        else:
            want_y = xs[(r - 1) % W]
            want_g = np.full_like(xs[r], cots[(r + 1) % W])
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(g, want_g)


def test_collective_counters_and_object_gather(collective_results):
    calls, nbytes = collective_results[0]["stats"]
    assert calls == {"all_reduce": 1} and nbytes == {"all_reduce": 20}
    assert collective_results[2]["objects"] == [{"rank": r}
                                               for r in range(4)]
