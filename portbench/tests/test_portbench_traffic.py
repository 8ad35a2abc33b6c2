"""The traffic is the same for the same seed, differs between seeds, and
gives every seed the same amount of work."""

import numpy as np

from portbench import registry, traffic

BIG = 2 ** 31 + 12345


def _plan_summary(mix, seed):
    plan = traffic.ServePlan(mix, seed)
    vids = [plan.video(i, v) for i in range(plan.N) for v in range(3)]
    return plan, vids, [plan.entry(i) for i in range(plan.N)]


def test_serve_plan_repeats_and_varies():
    mix = registry.traffic("narrate64")
    _, a, ea = _plan_summary(mix, BIG)
    _, b, eb = _plan_summary(mix, BIG)
    _, c, ec = _plan_summary(mix, BIG + 1)
    assert a == b and ea == eb
    assert a != c
    # the same multiset of lengths and entry points for every seed
    assert sorted(v["length"] for v in a) == sorted(v["length"] for v in c)
    assert sorted(ea) == sorted(ec)
    lo, hi = mix["video_frames"]
    assert all(lo <= v["length"] <= hi for v in a)


def test_entries_spread_over_the_first_video():
    """The window opens with the streams' next turnovers spread over a
    whole video, as in the steady state, not bunched after its middle."""
    mix = registry.traffic("narrate64")
    plan = traffic.ServePlan(mix, BIG)
    left = np.array([plan.video(i, 0)["length"] - plan.entry(i)
                     for i in range(plan.N)])
    lo, hi = mix["video_frames"]
    assert left.min() < 0.05 * hi and left.max() > 0.9 * lo
    # about as many turnovers due in each quarter of the shortest video
    counts = np.histogram(left, bins=4, range=(0, lo))[0]
    assert counts.min() >= 0.6 * counts.max()


def test_queries_on_frame_times():
    base = registry.traffic("narrate64")
    for mix in (base, dict(base, query_every=8)):
        plan = traffic.ServePlan(mix, 5)
        v = plan.video(3, 1)
        frames = [f for f, _ in v["queries"]]
        assert frames[0] == 0 and all(f < v["length"] for f in frames)
        if mix["query_every"]:
            assert np.all(np.diff(frames) == mix["query_every"])
        else:
            assert frames == [0]


def test_feature_bank_seeded():
    a = traffic.feature_bank(BIG, 8, 10, 16)
    assert np.array_equal(a, traffic.feature_bank(BIG, 8, 10, 16))
    assert not np.array_equal(a, traffic.feature_bank(BIG + 1, 8, 10, 16))
    assert a.dtype == np.float16


def test_every_mix_fits_its_kv_capacity():
    bench = registry.load_benchmark()
    for cell in bench["workloads"]:
        mix = registry.traffic(cell["traffic"])
        if mix["driver"] != "serve_backlog":
            continue
        live = registry.config(bench, cell["config"])["live"]
        need = traffic.worst_dialogue_tokens(mix, live["system_prompt"],
                                             live["frame_num_tokens"])
        assert need <= mix["kv_capacity"], cell["name"]

