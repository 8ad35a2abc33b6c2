"""The counts of roofline.py and of the Llama family's forward against
hand counts at small shapes."""

from portbench import roofline
from portbench.families import llama


def test_k3_call_by_hand():
    # two streams at slots 3 and 9, two queries each, window 4, Hq 4 Hkv 2 d 8
    f, b = roofline.k3_call([3, 9], 2, 4, 2, 8, 4, kv_bytes=2, q_bytes=2)
    # visible keys: stream 0 queries at 3, 4 -> min(4, 4) + min(5, 4) = 8;
    # stream 1 at 9, 10 -> 4 + 4 = 8
    assert f == 4 * 8 * 4 * 16
    # union of the visible slots: stream 0 [0, 4] (query 3 sees 0..3),
    # stream 1 [6, 10]: 10 slots of K and V, then q and out
    assert b == 2 * 10 * 2 * 8 * 2 + 2 * 2 * 4 * 2 * 8 * 2


def test_k3_call_without_window():
    f, b = roofline.k3_call([0], 1, 1, 1, 4, None, kv_bytes=1, q_bytes=1)
    assert f == 4 * 4 * 1 and b == 2 * 1 * 1 * 4 * 1 + 2 * 1 * 1 * 1 * 4


def _cfg(**kw):
    c = dict(hidden_size=8, intermediate_size=16, head_dim=2,
             num_attention_heads=4, num_key_value_heads=2, vocab_size=10,
             num_hidden_layers=3, sliding_window=None)
    c.update(kw)
    return c


def test_serve_forward_flops_by_hand():
    c = _cfg()
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    # one stream, 2 valid tokens at slots 5, 6; one head row
    f = llama.forward_flops(c, [2, 0], [5, 0], 1)
    assert f == 2 * per_layer * 3 * 2 + 4 * 2 * 4 * 3 * (6 + 7) + 2 * 8 * 10


def test_least_time_kind():
    assert roofline.least_time(989e12, 1.0) == (1.0, "operations")
    assert roofline.least_time(1.0, 3.35e12)[1] == "bytes"
