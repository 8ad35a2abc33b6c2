"""tick_idle_share.serve: the device's idle time under the batched
engine's ingest tick, its ``multistream.admit`` (admission, the tick's
collection and capacity guard), ``multistream.ingest`` (the ingest
forward's dispatch) and ``multistream.settle`` (the gate readback, its
bookkeeping, the schedule) spans, over the profiled sub-window's
length."""

from portbench.metrics._spans import idle_share_under


def read(rec, info):
    return idle_share_under(rec, ("multistream.admit", "multistream.ingest",
                                  "multistream.settle"))
