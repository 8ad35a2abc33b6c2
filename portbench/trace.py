"""The traced sub-window: ``torch.profiler`` over a short steady stretch of
a run, reduced to device busy time, time by kernel class and the host's
activity in the device's idle gaps.

Kernel classes are matched on the lowercased kernel name, first match
wins: the configuration's family's own (``KERNEL_CLASSES``) before the
shared ones here. K1 and K3 run one templated kernel over a pool type, so
they are told apart by the pool's name; the merge of their split partials
is a class of its own. The int8 weights' conversion copies
(``quantized_matmul``'s cast of the codes to bf16 before each cuBLAS
product, the gap a W8A16 kernel would close) are copies whose loads
convert.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = "portbench.window"

CLASSES: Tuple[Tuple[str, Callable[[str], bool]], ...] = (
    ("K3", lambda n: "pagedpool" in n),
    ("K1", lambda n: "ringpool" in n),
    ("K1/K3 merge", lambda n: "decode_merge_kernel" in n),
    ("K2f", lambda n: "k2_fwd" in n),
    ("K2b", lambda n: "k2_dkdv" in n),
    ("K2q", lambda n: "k2_dq" in n),
    ("K4", lambda n: "fused_mlp_q4c" in n or "swiglu_merge" in n
     or "fused_mlp_down_merge" in n),
    ("K5-K7", lambda n: "wo_kernel" in n or "matmul_int4c" in n
     or "fused_mlp_gemm" in n),
    ("cast copies", lambda n: "copy_kernel" in n and (
        "withcast" in n or "fetch_and_cast" in n or "templated" in n
        or "signed char" in n or "int8" in n)),
    ("copies", lambda n: "copy_kernel" in n),
    ("matmul", lambda n: any(m in n for m in (
        "nvjet", "gemm", "cutlass", "xmma", "sm90_", "ampere_", "cublas"))),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LONG_US = 1000.0
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def classify(name: str, kernel_classes: Sequence = ()) -> str:
    """The class of a kernel: the first of ``kernel_classes`` (a
    family's), then of ``CLASSES``, whose match takes the lowercased
    name."""
    n = name.lower()
    return next((c for c, match in (*kernel_classes, *CLASSES)
                 if match(n)), "other")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: List[Dict[str, Any]], kernel_classes: Sequence = ()
              ) -> Optional[Dict[str, Any]]:
    """Reduce chrome-trace events (microseconds) to the window's figures,
    in seconds: ``window_s``, ``busy_s`` (the union of device operations in
    the window), ``classes`` {class: [seconds, launches]}, ``kernels``
    {name: [seconds, launches]}, ``idle`` {host activity: seconds} and
    ``gaps``; kernels are classed by ``classify(name, kernel_classes)``. None
    when the window or any device operation is missing."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    classes: Dict[str, List[float]] = {}
    kernels: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e.get("name", "")
        cls = (classify(name, kernel_classes) if e["cat"] == "kernel"
               else e["cat"])
        for table, key in ((classes, cls), (kernels, name)):
            slot = table.setdefault(key, [0.0, 0])
            slot[0] += (b - a) * 1e-6
            slot[1] += 1
    if not dev:
        return None
    busy = _merge(dev)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and "dur" in e and e.get("name") != WINDOW),
                  key=lambda e: float(e["ts"]))
    h0 = np.array([float(e["ts"]) for e in host])
    h1 = h0 + np.array([float(e["dur"]) for e in host])
    names = [e.get("name", "") for e in host]
    # events longer than LONG_US are few: each gap checks all of them, and
    # of the others only those that start within LONG_US before it
    long_ = np.flatnonzero(h1 - h0 > LONG_US)
    outer_ok = np.array([not n.startswith(("aten::", "cuda", "cu"))
                         for n in names], bool)
    gaps = []
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        lo = np.searchsorted(h0, mid - LONG_US)
        hi = np.searchsorted(h0, mid, side="right")
        near = np.arange(lo, hi)
        cand = np.union1d(near, long_[h0[long_] <= mid])
        cover = cand[h1[cand] >= mid]
        name = "host (no recorded op)"
        if cover.size:
            span = h1[cover] - h0[cover]
            name = names[cover[np.argmin(span)]]
            outer = cover[outer_ok[cover]]
            if outer.size:
                top = names[outer[np.argmax(h1[outer] - h0[outer])]]
                if top != name:
                    name = f"{top} > {name}"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "classes": classes, "kernels": kernels, "idle": idle,
            "gaps": len(gaps)}


def breakdown(summary: Dict[str, Any]) -> Dict[str, List]:
    """The result line's ``breakdown``: the ten device classes and the ten
    host activities of the idle gaps that took the most seconds."""
    ops = sorted(((k, v[0]) for k, v in summary["classes"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


@contextmanager
def profiled(out_dir: Path, sync: Callable[[], None],
             kernel_classes: Sequence = ()):
    """Profile the body (CPU and CUDA activities) inside one
    ``portbench.window`` annotation, then export the trace to ``out_dir``,
    read it back and delete it. Yields a dict that gets ``summary``
    (``summarize`` with the family's ``kernel_classes``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    out: Dict[str, Any] = {}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            sync()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
    out["summary"] = summarize(events, kernel_classes)
    out["read_s"] = time.perf_counter() - t0
