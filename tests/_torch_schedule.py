"""The split-KV decode kernels' schedule (K1 and K3), checked against
the slots a query may see: shared by tests/test_torch_decode_attention.py
and tests/test_torch_paged.py."""

import numpy as np

from videollm_online_tpu_torch.ops import decode_attention as da

SCHEDULE_S = [1, 7, 20, 21, 64, 91, 128]


def _visible(q_pos, window, slots):
    """(slots,) bool: the slots some query at q_pos sees."""
    slot = np.arange(slots)[None]
    qp = np.asarray(q_pos)[:, None]
    vis = slot <= qp
    if window:
        vis &= slot > qp - window
    return vis.any(0)


def check_schedule(design, q_pos, window, slots, nsplit):
    """The splits cover the tiles that hold a visible slot, each once and
    no other (none past the last visible slot, none wholly below the
    window), and the slots the kernel loads, [lo, hi], are the visible
    ones."""
    bk = da.BLOCK_K[design]
    vis = _visible(q_pos, window, slots)
    want = sorted(set(np.flatnonzero(vis) // bk))
    ranges = da.split_ranges(design, q_pos, window, slots, nsplit)
    assert len(ranges) == nsplit
    got = [t for start, end in ranges for t in range(start, end)]
    assert got == want, (q_pos[0], window, nsplit, ranges)
    lo, hi = da.visible_slots(q_pos, window, slots)
    loaded = np.zeros(slots, bool)
    loaded[max(lo, 0):hi + 1] = True
    np.testing.assert_array_equal(loaded, vis)
