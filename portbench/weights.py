"""The weights of a configuration, made on the device from the seed.

A family's decoder (``families/<family>.py::make_decoder``) is made in the
type it is served in: weight-only int8 codes (``CODE_STD``) with one fp32
scale per output channel (per row for the embedding), rounded to bf16
values (``bf16_scale``), so a code times its scale is exact in bf16 and in
fp32 alike; norm weights and biases are random too, so every part of the
model moves the output. The connector is shared by every family. Both are
in the configuration's activation type, and every tensor comes from one
CUDA generator in a few large calls. The same tree goes to the program and
to the reference, which dequantizes it itself.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

CODE_STD = 127 / math.sqrt(3)   # std of codes uniform over [-127, 127]
LOGIT_STD = 4.0                 # the head's logits, roughly


def sub_seed(seed: int, tag: int) -> int:
    """A seed for one stream of randomness, from the run's seed and a tag."""
    state = np.random.SeedSequence([abs(int(seed)), int(tag)])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def bf16_scale(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def make(family, c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """{"llama", "connector"} for configuration ``c`` (the configuration
    file's JSON): the decoder of ``family`` (``make_decoder``), then the
    connector, from one generator. The port's live model takes its decoder
    under "llama", whatever the family (``models/live.py``)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    D = c["hidden_size"]
    fdt = getattr(torch, c["activations"])
    llama = family.make_decoder(c, g, device)
    vh = c["live"]["vision_hidden_size"]

    def uniform(shape, bound):
        u = torch.rand(shape, generator=g, device=device)
        return ((u * 2 - 1) * bound).to(fdt)

    connector = {"fc1": {"w": uniform((vh, D), 1 / math.sqrt(vh)),
                         "b": uniform((D,), 0.1)},
                 "fc2": {"w": uniform((D, D), 1 / math.sqrt(D)),
                         "b": uniform((D,), 0.1)}}
    return {"llama": llama, "connector": connector}
