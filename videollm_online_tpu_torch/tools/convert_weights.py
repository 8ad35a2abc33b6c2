"""One-time HF -> port weight conversion.

Counterpart of the JAX package's ``tools/convert_weights.py``: reads an HF
safetensors checkpoint (one file or a directory of shards), converts it
with ``models/convert.py`` (a Llama, Mistral or Qwen2 decoder, or the
SigLIP tower), optionally stores the decoder weight-only int8 or int4
(``models/quant.py``) and writes the tree with
``train/checkpoints.save_params`` (``<dst>/params.pt``), which
``serve/cli.py --checkpoint`` serves and ``--vision_checkpoint`` reads.

  python -m videollm_online_tpu_torch.tools.convert_weights \\
      --src /path/llama3-8b --dst /path/llama3-8b-torch --family llama \\
      --size 8b [--int8 | --int4] [--dtype bfloat16] [--device cpu]
  python -m videollm_online_tpu_torch.tools.convert_weights \\
      --src /path/siglip --dst ... --family siglip

The conversion runs on the card unless ``--device cpu`` asks for the CPU;
the weights are stored in ``--dtype`` (default: the config's, bfloat16).
"""

from __future__ import annotations

import argparse

from ..core.config import (LlamaConfig, VisionConfig, mistral_7b_config,
                           qwen2_7b_config)
from ..core.device import resolve_device
from ..models import convert, quant
from ..models.builder import PROXY_SIZES
from ..train.checkpoints import save_params
from ..train.optim import tree_leaves


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", required=True,
                   help="safetensors file or directory (HF checkpoint)")
    p.add_argument("--dst", required=True, help="output directory")
    p.add_argument("--family", default="llama",
                   choices=["llama", "mistral", "qwen2", "siglip"])
    p.add_argument("--size", default="8b", choices=["8b", "1b", "tiny"],
                   help="the llama family's size preset (the builder's and "
                        "the serving cli's --model_size)")
    p.add_argument("--int8", action="store_true",
                   help="store the decoder weight-only int8")
    p.add_argument("--int4", action="store_true",
                   help="store the decoder weight-only int4 (group-128 "
                        "scales; the embedding stays int8)")
    p.add_argument("--dtype", default="",
                   help="dtype of the stored weights (default: the "
                        "config's, bfloat16)")
    p.add_argument("--device", default="",
                   help="'cpu' to convert on the CPU (default: the card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device or None)
    sd = convert.load_safetensors_state_dict(args.src)
    dtype = args.dtype or None
    if args.family == "siglip":
        params = convert.siglip_params_from_state_dict(
            sd, VisionConfig(), dtype=dtype, device=device)
    else:
        if args.family == "mistral":
            cfg = mistral_7b_config()
        elif args.family == "qwen2":
            cfg = qwen2_7b_config()
        else:
            # the size presets are the builder's and the cli's, so a
            # converted tiny checkpoint serves with --model_size tiny
            cfg = LlamaConfig(**PROXY_SIZES[args.size])
        params = convert.llama_params_from_state_dict(sd, cfg, dtype=dtype,
                                                      device=device)
        if args.int4:
            params = quant.quantize_llama_params(params, bits=4)
        elif args.int8:
            params = quant.quantize_llama_params(params)
    save_params(args.dst, params)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"converted {n / 1e9:.2f}B params -> {args.dst}")
    return params


if __name__ == "__main__":
    main()
