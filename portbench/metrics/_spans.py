"""Shared arithmetic of the span readers (not a metric itself): the
device's idle time in the profiled sub-window that ``trace.summarize``
put under one of the batched engine's phase spans, over the sub-window.

``summarize`` names an idle gap after the longest host event around it
that is not an ``aten::`` or CUDA call, ``"<that event> > <innermost>"``;
the engine's phases (``multistream.admit``, ``.ingest``, ...) are its
outermost spans, so a gap is under a phase when its name is the phase's
or starts with ``"<phase> > "``. A trace with no gap under any
``multistream.`` span is from a program that opens none: nothing to
read.
"""

ENGINE = "multistream."


def under(name, span):
    return name == span or name.startswith(span + " > ")


def idle_share_under(rec, spans):
    s = rec.get("trace")
    if not s or not s["window_s"]:
        return None
    idle = s["idle"]
    if not any(k.startswith(ENGINE) for k in idle):
        return None
    t = sum(v for k, v in idle.items() if any(under(k, sp) for sp in spans))
    return 100.0 * t / s["window_s"]
