"""respond_idle_share.serve: the device's idle time under the batched
engine's ``multistream.respond`` span (a respond program: prompt build,
its prompt and decode forwards, each forward's token readback, the
detokenising), over the profiled sub-window's length."""

from portbench.metrics._spans import idle_share_under


def read(rec, info):
    return idle_share_under(rec, ("multistream.respond",))
