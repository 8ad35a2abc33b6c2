"""The port's MultiStreamEngine against the JAX MultiStreamEngine, the
speculative and operational surface: n-gram spec decode over the fp32
paged pool with its back-off, shedding under ``max_lag_frames``, a
``pool_pages`` override, ``swap_params`` (which drops the prefix cache)
followed by a re-admission, and zero drafts over the batched ring.

Same method as ``test_torch_multistream.py``, whose helpers it uses: one
engine pair per fixture on the same weights, driven through a scenario;
``step()`` results, transcripts, ``spec_stats()`` and the host state
(offsets, tables, refcounts, ``stats()``) equal byte for byte.
"""

import numpy as np
import pytest
import torch

from test_torch_multistream import (_drain, _feats, _feed_schedule, _pair,
                                    _params, _snapshot)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs its
    files in parallel processes, where torch's default of a thread a core
    oversubscribes the CPU and its spinning workers slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paged_spec_run():
    """fp32 paged KV with n-gram spec decode, a pool smaller than the
    default (pool_pages 20 for 2 x 12 pages) and max_lag_frames 6: stream 0
    is handed 10 frames at once and sheds its 4 oldest. Then spec decode is
    backed off (greedy from there on), the weights are swapped, which drops
    the prefix cache, and slot 0 is closed and re-admitted under the new
    weights."""
    engines = _pair(5, dict(num_streams=2, kv_capacity=768, chunk_frames=4,
                            paged=True, page_size=64, spec_decode=True,
                            pool_pages=20, max_lag_frames=6))
    jparams2, params2 = _params(6, engines[0].cfg)
    rng = np.random.RandomState(17)
    lagged, f1, f1b, new = (_feats(rng, n) for n in (10, 3, 4, 4))
    rec = {}
    for name, ms, swap in zip(("jax", "port"), engines, (jparams2, params2)):
        assert ms.paged and ms.pool_pages == 20
        r = {}
        ms.input_frames(0, 0.0, lagged)
        ms.input_frames(1, 0.0, f1)
        ms.input_query(1, "what now?", video_time=0.2)
        r["spec_out"] = _drain(ms, [[] for _ in range(2)])
        r["snap_spec"] = _snapshot(ms)
        r["spec"] = np.asarray(ms.spec_stats()).tolist()
        r["no_backoff"] = ms.maybe_backoff_spec()        # too few steps
        r["backoff"] = ms.maybe_backoff_spec(min_tokens_per_step=1e9,
                                             min_steps=1)
        r["spec_after"] = ms.spec_decode
        ms.input_frames(1, 0.6, f1b)
        ms.input_query(1, "and now?", video_time=0.8)
        r["greedy_out"] = _drain(ms, [[] for _ in range(2)])
        ms.swap_params(swap)
        r["snap_swap"] = _snapshot(ms)
        r["closed"] = ms.close_stream(0)
        ms.input_frames(0, 0.0, new)
        ms.input_query(0, "anything?", video_time=0.3)
        r["readmit"] = _drain(ms, [[] for _ in range(2)])
        r["snap_readmit"] = _snapshot(ms)
        rec[name] = r
    return rec


@pytest.fixture(scope="module")
def ring_zero_draft_run():
    """The batched ring with spec decode drafting zeros
    (spec_draft_mode="zero"): the verify forward still emits the greedy
    tokens."""
    engines = _pair(4, dict(num_streams=2, kv_capacity=512, chunk_frames=4,
                            spec_decode=True, spec_draft_mode="zero"),
                    max_response_tokens=12)
    rng = np.random.RandomState(23)
    feats = [_feats(rng, 5), _feats(rng, 5)]
    rec = {}
    for name, ms in zip(("jax", "port"), engines):
        assert not ms.paged
        out = _feed_schedule(ms, feats, {0: (0.4, "what now?"),
                                         1: (0.7, "and here?")},
                             [0.0, 0.5, 1.0])
        rec[name] = dict(out=out, snap=_snapshot(ms),
                         spec=np.asarray(ms.spec_stats()).tolist())
    return rec


def test_paged_spec_decode_lag_shedding_equal_jax(paged_spec_run):
    j, p = paged_spec_run["jax"], paged_spec_run["port"]
    assert p["spec_out"] == j["spec_out"]
    assert p["snap_spec"] == j["snap_spec"]
    assert p["spec"] == j["spec"] and j["spec"][0] > 0
    assert j["snap_spec"]["streams"][0]["dropped_frames"] == 4
    assert j["snap_spec"]["pool"]["pages_total"] == 19


def test_paged_spec_backoff_equal_jax(paged_spec_run):
    j, p = paged_spec_run["jax"], paged_spec_run["port"]
    assert (p["no_backoff"], p["backoff"], p["spec_after"]) == \
        (j["no_backoff"], j["backoff"], j["spec_after"]) == (False, True,
                                                             False)
    assert p["greedy_out"] == j["greedy_out"]
    assert len(j["greedy_out"][1]) >= 1


def test_paged_swap_params_and_readmission_equal_jax(paged_spec_run):
    j, p = paged_spec_run["jax"], paged_spec_run["port"]
    assert p["snap_swap"] == j["snap_swap"]
    assert j["snap_swap"]["pool"]["prefix_entries"] == 0
    assert p["closed"] == j["closed"]
    assert p["readmit"] == j["readmit"]
    assert p["snap_readmit"] == j["snap_readmit"]
    assert j["snap_readmit"]["pool"]["prefix_entries"] == 1
    assert len(j["readmit"][0]) >= 1


def test_ring_spec_zero_draft_equal_jax(ring_zero_draft_run):
    j, p = ring_zero_draft_run["jax"], ring_zero_draft_run["port"]
    assert p["out"] == j["out"]
    assert p["snap"] == j["snap"]
    assert p["spec"] == j["spec"] and j["spec"][0] > 0
