"""tick_p50_ms: the median host time of one ``MultiStreamEngine.step()``
over the metered window (the batched engine's tick: ingest forward, gate
readback, respond program)."""

import statistics


def read(rec, info):
    ticks = rec.get("ticks_s")
    return statistics.median(ticks) * 1e3 if ticks else None
