"""A served dialogue rebuilt from what the benchmark fed the engine and what
the engine answered, and judged against the fp32 reference decoder.

The engine's KV for one dialogue holds, in order: the start ids (system
prompt and stream prompt); frames, each ``frame_num_tokens`` embeddings,
joined by the interval token; at a response, the frames up to and including
the one at the query's time, the query prompt (the generation prompt after
a gate fire; the pending interval token is dropped), and the response's
tokens but its last; the last token (with the stream prompt after an
<eos>) goes in front of the next frame. Position p of that sequence
predicts the token at p + 1, so a response's k-th token is judged at the
position before it, and a frame's gate at the frame's last token.

The decoder is the configuration's family's reference module (``ref``:
``embed_ids``, ``final_hidden`` and ``logits`` over ``params["llama"]``),
which the caller passes in; the connector and the control's rounding are
shared (``common.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import tokenizer as tk
from .common import Rounder, connector


def layout(d: Dict[str, Any], system_prompt: str, interval_id: int
           ) -> Tuple[List[Tuple[str, int]], List[Tuple[int, int, int]],
                      List[Tuple[int, float]]]:
    """(items, judged, gates): items are ("t", token id) or ("f", frame
    index) in KV order; judged are (position, served token, response index)
    for each token of the responses of ``d["responses"]`` marked ``judge``;
    gates are (position, the program's gate margin) for each frame of
    ``d["gates"]`` (frame, margin) that the items reach."""
    items: List[Tuple[str, int]] = [("t", t) for t in
                                    tk.encode(tk.start_text(system_prompt))]
    pos = [0]

    def n_tokens():
        return pos[0]

    def put(kind, val, width):
        items.append((kind, val))
        pos[0] += width

    pos[0] = len(items)
    judged: List[Tuple[int, int, int]] = []
    fnt = d["frame_num_tokens"]
    nxt, prepend, ends = 0, [], {}
    for n_r, r in enumerate(d["responses"]):
        for j in range(nxt, r["frame"] + 1):
            if j == nxt:
                for t in prepend:
                    put("t", t, 1)
                prepend = []
            else:
                put("t", interval_id, 1)
            put("f", j, fnt)
            ends[j] = n_tokens() - 1
        nxt = r["frame"] + 1
        prompt = tk.encode(tk.query_text(r["query"]) if r["query"] is not None
                           else tk.GEN_PROMPT)
        for t in prompt:
            put("t", t, 1)
        ids = r["ids"]
        for k, t in enumerate(ids):
            if r.get("judge", True):
                judged.append((n_tokens() - 1, t, n_r))
            if k < len(ids) - 1:
                put("t", t, 1)
        prepend = [ids[-1]] + (tk.encode(tk.STREAM_PROMPT)
                               if ids[-1] == tk.EOS_ID else [])
    gates = [(ends[f], m) for f, m in d.get("gates", []) if f in ends]
    return items, judged, gates


def embed(ref, items: Sequence[Tuple[str, int]], params: Dict[str, Any],
          frame_feats, device) -> torch.Tensor:
    """(T, D) fp32 embeddings: text ids through the dequantized table, frames
    (``frame_feats(j)`` -> (fnt, vision_hidden)) through the connector."""
    parts, run = [], []

    def flush():
        if run:
            parts.append(ref.embed_ids(
                params["llama"], torch.tensor(run, device=device)))
            run.clear()

    for kind, val in items:
        if kind == "t":
            run.append(val)
        else:
            flush()
            f = torch.from_numpy(np.asarray(frame_feats(val))).to(device)
            parts.append(connector(params["connector"], f))
    flush()
    return torch.cat(parts)


def judge(ref, params: Dict[str, Any], c: Dict[str, Any], seqs, judged,
          gated, gate_id: int, control: bool = False) -> Dict[str, Any]:
    """Per sequence, the gap by which each served token's reference logit
    lies below the reference's best, and at each gated frame the difference
    between the program's gate margin and the reference's; with ``control``
    also the same two readings of the fp8 control at the same positions
    (the gap of the token that it puts first, its own gate margin)."""
    hid = ref.final_hidden(params["llama"], c, seqs)
    ctl = (ref.final_hidden(params["llama"], c, seqs, Rounder(fp8=True))
           if control else None)
    gaps, cgaps, ggaps, cggaps = [], [], [], []
    for n, (h, jd, gd) in enumerate(zip(hid, judged, gated)):
        if jd:
            p = torch.tensor([q for q, _, _ in jd], device=h.device)
            tok = torch.tensor([t for _, t, _ in jd], device=h.device)
            lg = ref.logits(params["llama"], h[p])
            best = lg.max(dim=-1).values
            gaps.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu())
            if ctl is not None:
                lc = ref.logits(params["llama"], ctl[n][p], Rounder(fp8=True))
                pick = lc.argmax(dim=-1)
                cgaps.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
        if gd:
            p = torch.tensor([q for q, _ in gd], device=h.device)
            prog = torch.tensor([m for _, m in gd])
            want = gate_margin(ref.logits(params["llama"], h[p]),
                               gate_id).cpu()
            ggaps.append((prog - want).abs())
            if ctl is not None:
                lc = ref.logits(params["llama"], ctl[n][p], Rounder(fp8=True))
                cggaps.append((gate_margin(lc, gate_id).cpu() - want).abs())
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    gg = torch.cat(ggaps) if ggaps else torch.zeros(0)
    out = {"tokens": int(g.numel()), "gaps": g,
           "max_gap": float(g.max()) if g.numel() else 0.0,
           "mean_gap": float(g.mean()) if g.numel() else 0.0,
           "flips": int((g > 0).sum()),
           "gates": int(gg.numel()),
           "gate_gap": float(gg.max()) if gg.numel() else 0.0}
    if control:
        cg = torch.cat(cgaps)
        cgg = torch.cat(cggaps) if cggaps else torch.zeros(0)
        out.update(control_max_gap=float(cg.max()),
                   control_mean_gap=float(cg.mean()),
                   control_flips=int((cg > 0).sum()),
                   control_gate_gap=float(cgg.max()) if cgg.numel() else 0.0)
    return out


def gate_margin(lg: torch.Tensor, gate_id: int) -> torch.Tensor:
    """(..., V) logits -> the gate token's logit less the best other's
    (positive: the gate holds)."""
    other = lg.clone()
    other[..., gate_id] = float("-inf")
    return lg[..., gate_id] - other.amax(dim=-1)
