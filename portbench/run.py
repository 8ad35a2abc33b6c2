"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, model family,
traffic mix, driver and metric readers are found by name
(``registry.py``). ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` its per-layer metrics, from a profiled sub-window and a
metered window after it. Without as many CUDA devices as the cell asks
for, it exits with code 3 and prints no result. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each compared number beside its limit (also the last
lines of standard error).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# caches of anything that compiles stay inside the checkout, at fixed paths;
# no library of the port may bring in JAX
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(REPO / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "videollm_online_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that this run may not load,
    compared whole (``videollm_online_tpu_torch`` is not
    ``videollm_online_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: Optional[Dict[str, Any]] = None,
             config: Optional[Dict[str, Any]] = None,
             mix: Optional[Dict[str, Any]] = None, control: bool = False,
             patch=None, t0: float = None) -> Dict[str, Any]:
    """Drive one run of a cell and assemble its result (the caller has
    checked the devices). ``config`` / ``mix`` / ``patch`` replace the
    cell's files or break the timed path underneath, for the CPU tests."""
    from portbench import registry

    bench = bench or registry.load_benchmark()
    cell = registry.workload(bench, workload)
    config = config or registry.config(bench, cell["config"])
    ctx = SimpleNamespace(
        config=config, family=registry.family(config),
        mix=mix or registry.traffic(cell["traffic"]), seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        out_dir=REPO / "portbench" / "out", control=control, patch=patch,
        t0=T0 if t0 is None else t0)
    drv = registry.driver(ctx.mix["driver"])
    res = drv.run(ctx)
    limit_w = power_limit_w() if device != "cpu" else None
    metrics: Dict[str, Any] = {}
    if not trace:
        for m in registry.end_to_end(bench, workload):
            v = (res["setup_s"] if m["name"] == "setup_s"
                 else res["metrics"].get(m["name"]))
            if v is None:
                raise RuntimeError(f"{workload}: no reading of {m['name']}")
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        info = {"power_limit_w": limit_w, "config": ctx.config}
        for m in registry.per_layer(bench, workload):
            v = registry.metric_reader(m["name"])(res["record"], info)
            if v is None:
                continue
            entry = v if isinstance(v, dict) else {"value": v}
            metrics[m["name"]] = {"value": float(entry.pop("value")),
                                  "unit": m["unit"], **entry}
    out = {"correct": bool(res["correct"]),
           "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics}
    if device == "cpu":
        out["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    else:
        import torch
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": int(res["memory_peak_bytes"]),
                         "power_limit_w": limit_w}
    summary = res["record"].get("trace")
    if trace:
        if summary is None:
            raise RuntimeError("the traced run recorded no device operation")
        from portbench import trace as tr
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = tr.breakdown(summary)
    out["checks"] = res["checks"]
    out["_stats"] = dict(res.get("stats", {}),
                         trace_read_s=res["record"].get("trace_read_s"))
    out["_summary"] = summary
    out["_classes"] = ctx.family.KERNEL_CLASSES
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="compare the fp8 control's readings in the "
                         "program's place (not a measurement run)")
    args = ap.parse_args(argv)

    from portbench import registry
    bench = registry.load_benchmark()
    chips = registry.workload(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   bench=bench, control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    stats = out.pop("_stats")
    summary = out.pop("_summary", None)
    classes = out.pop("_classes")
    if summary is not None:
        from portbench import trace as tr
        top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
        for name, (secs, n) in top[:15]:
            print(f"kernel {secs * 1e3:9.2f} ms x{n:<5d} "
                  f"[{tr.classify(name, classes)}] {name[:110]}",
                  file=sys.stderr)
        print("classes " + json.dumps(summary["classes"]), file=sys.stderr)
    print("portbench stats: " + json.dumps(
        {k: v for k, v in stats.items() if not hasattr(v, "shape")}),
        file=sys.stderr)
    for name, chk in out["checks"].items():
        print(f"check {name}: {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
