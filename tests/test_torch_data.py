"""The port's copies of the data layer against the JAX package's.

``data/registry.py`` and every dataset it registers, on the synthetic
Ego4D and COIN roots of ``tests/test_datasets.py`` and ``tests/_synthetic``:
the same dataset names, the same samples (text, frames, learn ranges,
index, evaluation kwargs; ``random`` seeded alike where a dataset draws),
the same ``compute_metrics`` on the same predictions. Then the text
metrics (the native library and the pure-Python path) and the fps-grid
helpers.
"""

import random

import numpy as np
import pytest

from videollm_online_tpu.core.config import live1_plus_config as jax_cfg
from videollm_online_tpu.data import registry as jax_registry
from videollm_online_tpu.data import utils as jax_utils
from videollm_online_tpu.tokenizer.live_tokenizer import (
    LiveTokenizer as JaxTokenizer)
from videollm_online_tpu.tokenizer.tiny import ByteTokenizer as JaxBytes
from videollm_online_tpu.utils import text_metrics as jax_tm

from videollm_online_tpu_torch.core.config import live1_plus_config
from videollm_online_tpu_torch.data import registry, utils
from videollm_online_tpu_torch.tokenizer.live_tokenizer import LiveTokenizer
from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer
from videollm_online_tpu_torch.utils import text_metrics

from _synthetic import common_data_kwargs, make_coin_root
from test_datasets import ego4d_root  # noqa: F401  (the synthetic tree)

EGO4D = ["ego4d_narration_stream_train",
         "ego4d_refined_narration_stream_train",
         "ego4d_goalstep_livechat_trainval", "ego4d_lta_train",
         "ego4d_nlq_stream_train"]
COIN = [f"coin_{kind}_{split}"
        for kind in ("step", "next", "task", "procedure", "taskprocedure")
        for split in ("train", "test")]


@pytest.fixture(scope="module")
def coin_root(tmp_path_factory):
    return make_coin_root(str(tmp_path_factory.mktemp("coin")))


@pytest.fixture(scope="module")
def toks():
    return (JaxTokenizer(JaxBytes(), jax_cfg()),
            LiveTokenizer(ByteTokenizer(), live1_plus_config()))


def _root(name, ego4d_root, coin_root):
    return coin_root if name.startswith("coin") else ego4d_root


def _build(reg, name, tok, root, is_training, augmentation=False, seed=0):
    random.seed(seed)
    kw = common_data_kwargs(tok, root)
    kw.update(augmentation=augmentation)
    return reg._REGISTRY[name](is_training=is_training, **kw)


def _items(ds, seed):
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        text, frames, ranges, idx, ekw = g
        assert text == w[0]
        np.testing.assert_array_equal(np.asarray(frames), np.asarray(w[1]))
        assert ranges == w[2] and idx == w[3] and ekw == w[4]


def test_available_datasets_equal():
    assert registry.available_datasets() == jax_registry.available_datasets()


@pytest.mark.parametrize("is_training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", EGO4D + COIN)
def test_dataset_items_equal(name, is_training, ego4d_root, coin_root,
                             toks):
    root = _root(name, ego4d_root, coin_root)
    jtok, tok = toks
    want_ds = _build(jax_registry, name, jtok, root, is_training)
    got_ds = _build(registry, name, tok, root, is_training)
    _assert_items_equal(_items(got_ds, 1), _items(want_ds, 1))


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_augmented_truncated_stream_equal(seed, ego4d_root, toks):
    """Stream-dropout augmentation and the max_num_frames clip draw from
    ``random`` alike in both packages."""
    jtok, tok = toks
    name = "ego4d_narration_stream_train"
    kw = dict(is_training=True, augmentation=True, seed=seed)
    want_ds = _build(jax_registry, name, jtok, ego4d_root, **kw)
    got_ds = _build(registry, name, tok, ego4d_root, **kw)
    want_ds.max_num_frames = got_ds.max_num_frames = 6
    _assert_items_equal(_items(got_ds, seed), _items(want_ds, seed))


def test_robustness_equal(toks):
    jtok, tok = toks
    kw = dict(is_training=True, system_prompt="sys.", augmentation=False,
              max_num_frames=1200, vision_hidden_size=32)
    want = jax_registry._REGISTRY["robustness"](tokenizer=jtok, **kw)
    got = registry._REGISTRY["robustness"](tokenizer=tok, **kw)
    _assert_items_equal(_items(got, 0), _items(want, 0))


def _predictions(name, ds, tok, rng):
    """Predictions of the shape each dataset's evaluator returns."""
    n = len(ds)
    if name in ("ego4d_narration_stream_train", "ego4d_nlq_stream_train",
                "ego4d_refined_narration_stream_train"):
        return rng.rand(n, 4) * [5.0, 3.0, 1.0, 1.0]
    if name == "ego4d_lta_train":
        gt = ds.labels_to_text(list(zip(ds.annos_verb_labels[0],
                                        ds.annos_noun_labels[0])))
        # the evaluator's beams, of one length: the ground truth and a
        # shuffle of it
        gt_ids = np.asarray(tok.encode(gt))
        rows = [gt_ids, rng.permutation(gt_ids)]
        return np.stack([np.concatenate([rows[(i + b) % 2]
                                         for b in range(5)])
                         for i in range(n)])
    # COIN: the answer of every other sample, noise for the rest
    rows = []
    for i in range(n):
        text = (ds.annos[i]["conversation"][-1]["content"] if i % 2 == 0
                else "pour beans")
        rows.append(np.asarray(tok.encode(text)))
    out = np.full((n, max(len(r) for r in rows)), -100)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


@pytest.mark.parametrize("name", [n for n in EGO4D + COIN
                                  if "livechat" not in n])
def test_compute_metrics_equal(name, ego4d_root, coin_root, toks):
    root = _root(name, ego4d_root, coin_root)
    jtok, tok = toks
    want_ds = _build(jax_registry, name, jtok, root, False)
    got_ds = _build(registry, name, tok, root, False)
    preds = _predictions(name, got_ds, tok, np.random.RandomState(7))
    idxs = np.arange(len(got_ds))
    want = want_ds.compute_metrics(preds, idxs, tokenizer=jtok)
    got = got_ds.compute_metrics(preds, idxs, tokenizer=tok)
    assert got == want


def test_concat_and_eval_dict_equal(coin_root, toks):
    jtok, tok = toks
    names = ["coin_step_train", "coin_task_train"]
    want = jax_registry.build_concat_train_dataset(
        names, **common_data_kwargs(jtok, coin_root))
    got = registry.build_concat_train_dataset(
        names, **common_data_kwargs(tok, coin_root))
    assert len(got) == len(want) == 7
    _assert_items_equal([got[5], got[-1]], [want[5], want[-1]])
    eval_dict = registry.build_eval_dataset_dict(
        ["coin_step_test", "coin_task_test"],
        **common_data_kwargs(tok, coin_root))
    assert list(eval_dict) == ["coin_step_test", "coin_task_test"]
    assert registry.build_eval_dataset_dict(None) is None
    with pytest.raises(KeyError, match="unknown dataset"):
        registry.build_concat_train_dataset(["no_such_set"])


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_text_metrics_equal(native, monkeypatch):
    if native and text_metrics._native_lib() is None:
        pytest.skip("native/build/libtextops.so is not built")
    if not native:
        for mod in (text_metrics, jax_tm):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    words = ["grind beans", "boil water", "pour water", "lift car",
             "remove wheel", "open the door", "", "x"]
    choices = [f"{a} {b}" for a in ("pour", "boil", "grind")
               for b in ("water", "beans", "tea", "milk")]
    for a in words:
        for b in words:
            assert text_metrics.levenshtein(a, b) == jax_tm.levenshtein(a, b)
        assert (text_metrics.fuzzy_match(a, choices)
                == jax_tm.fuzzy_match(a, choices))
    rng = np.random.RandomState(0)
    for _ in range(10):
        x, y = rng.randint(0, 9, rng.randint(0, 12)), rng.randint(0, 9, 7)
        assert (text_metrics.edit_distance_ids(x, y)
                == jax_tm.edit_distance_ids(x, y))


@pytest.mark.parametrize("fn", ["round_time_by_fps", "ceil_time_by_fps",
                                "floor_time_by_fps"])
def test_fps_grid_equal(fn):
    for t in np.linspace(-1.0, 61.0, 97):
        args = (float(t), 2.0, 0.0, 60.0)
        assert getattr(utils, fn)(*args) == getattr(jax_utils, fn)(*args)
    assert (utils.temporal_iou([0, 2], [1, 3])
            == jax_utils.temporal_iou([0, 2], [1, 3]))
