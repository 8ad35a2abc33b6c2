"""Offline stage 2: batched SigLIP feature extraction (reference
data/preprocess/encode.py + data/utils.py:86-104).

  python -m videollm_online_tpu_torch.data.preprocess.encode_job \
      --video_dir datasets/ego4d/v2/full_scale_2fps_max384 \
      --weights /path/siglip.safetensors --live_version live1+ [--device cpu]

Counterpart of ``videollm_online_tpu/data/preprocess/encode_job.py``:
``frame_features`` (models/siglip.py) encodes 256-frame batches, the last
one zero-padded to the full batch as the JAX job pads it; features land as
fp16 ``.npy`` per video (memory-mappable by the feature store; the reference
saves bf16 ``.pt``). Work shards across tasks by file index; existing
outputs are skipped. Weights come from an HF safetensors checkpoint through
models/convert.py, or are random (seed 0) without one. The job runs on the
card unless ``--device cpu`` asks for the CPU."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ...core.config import LiveConfig, live1_config, live1_plus_config
from ...core.device import resolve_device
from ...models import siglip
from ..video_io import read_video_frames
from .sharding import shard

ENCODE_BATCH = 256  # reference data/preprocess/encode.py:25


@torch.no_grad()
def encode(params, frames: torch.Tensor, cfg: LiveConfig) -> torch.Tensor:
    """(B, 3, H, W) uint8 frames -> (B, frame_num_tokens, D) features."""
    return siglip.frame_features(
        params, siglip.preprocess(frames, cfg.vision), cfg.vision, cfg)


def run(video_dir: str, *, live_version: str = "live1+",
        vision_pretrained: str = "google/siglip-large-patch16-384",
        weights: str = "", batch_size: int = ENCODE_BATCH,
        save_fp16: bool = True, overwrite: bool = False,
        embed_mark: str = None, device=None):
    device = resolve_device(device)
    cfg = live1_plus_config() if live_version == "live1+" else live1_config()
    vcfg = cfg.vision
    if weights:
        from ...models.convert import (load_safetensors_state_dict,
                                       siglip_params_from_state_dict)
        params = siglip_params_from_state_dict(
            load_safetensors_state_dict(weights), vcfg, device=device)
    else:
        params = siglip.init_params(
            torch.Generator(device=device).manual_seed(0), vcfg,
            device=device)

    src_root = video_dir.rstrip("/")
    embed_mark = embed_mark or ("2fps_384_1+3x3" if live_version == "live1+"
                                else "2fps_384_1")
    dst_root = (f"{src_root}_{embed_mark.split('_')[-1]}_"
                f"{vision_pretrained.replace('/', '--')}")
    os.makedirs(dst_root, exist_ok=True)
    files = sorted(os.listdir(src_root))
    done = 0
    for _, file in shard(files):
        src = os.path.join(src_root, file)
        dst = os.path.join(dst_root, os.path.splitext(file)[0] + ".npy")
        if os.path.exists(dst) and not overwrite:
            continue
        frames = read_video_frames(src)  # (T, 3, H, W) uint8
        chunks = []
        for i in range(0, frames.shape[0], batch_size):
            batch = frames[i:i + batch_size]
            pad = batch_size - batch.shape[0]
            if pad:  # the JAX job's static batch shape
                batch = np.concatenate(
                    [batch, np.zeros((pad,) + batch.shape[1:], batch.dtype)])
            pixels = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
            feats = encode(params, pixels, cfg).float().cpu().numpy()
            chunks.append(feats[:batch_size - pad if pad else batch_size])
        feats = np.concatenate(chunks)
        np.save(dst, feats.astype(np.float16 if save_fp16 else np.float32))
        done += 1
    print(f"encode_job: encoded {done} videos -> {dst_root}")
    return dst_root


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--live_version", default="live1+")
    p.add_argument("--vision_pretrained",
                   default="google/siglip-large-patch16-384")
    p.add_argument("--weights", default="")
    p.add_argument("--batch_size", type=int, default=ENCODE_BATCH)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="",
                   help="'cpu' for the CPU; the card otherwise")
    a = p.parse_args(argv)
    run(a.video_dir, live_version=a.live_version,
        vision_pretrained=a.vision_pretrained, weights=a.weights,
        batch_size=a.batch_size, overwrite=a.overwrite,
        device=a.device or None)


if __name__ == "__main__":
    main()
