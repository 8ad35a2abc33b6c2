"""turnover_idle_share.serve: the device's idle time under the batched
engine's stream I/O, its ``multistream.input`` (``input_frames`` /
``input_query``: a video's features to the card and through the
connector) and ``multistream.close`` (``close_stream``) spans, over the
profiled sub-window's length."""

from portbench.metrics._spans import idle_share_under


def read(rec, info):
    return idle_share_under(rec, ("multistream.input", "multistream.close"))
