"""Tiny configurations and mixes for the CPU tests: the real files' keys at
widths a CPU runs in seconds."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def config(name="qwen2-7b-int8", **kw):
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=512)
    # a window short enough that the tiny dialogues outgrow it
    c.update(use_sliding_window=True, sliding_window=48)
    c["activations"] = "float32"
    c["init"] = {"qk_gain": 2.0}
    c["live"] = dict(c["live"], vision_hidden_size=32)
    c.update(kw)
    return c


def serve_mix(name="narrate64", **kw):
    m = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    m.update(streams=3, kv_capacity=1536, page_size=64, chunk_frames=4,
             video_frames=[20, 40], max_new_tokens=5,
             bank_frames=64, sample_dialogues=2, profile_seconds=0.5)
    m.update(kw)
    return m


def bench(cell, cfg_name, mix_name, like):
    """BENCHMARK.json with one cell, ``cell``, that reports what the real
    cell ``like`` reports."""
    b = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    b = copy.deepcopy(b)
    b["workloads"] = [{"name": cell, "config": cfg_name, "traffic": mix_name,
                       "chips": 1, "why": "test"}]
    for sec in ("end_to_end", "per_layer"):
        for m in b[sec]:
            if "workloads" in m:
                m["workloads"] = [cell] if like in m["workloads"] else []
    return b

