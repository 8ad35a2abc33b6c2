"""Offline stage 1: fps resample + resize videos (reference
data/preprocess/ffmpeg.py + data/utils.py:68-84).

  python -m videollm_online_tpu_torch.data.preprocess.ffmpeg_job \
      --video_dir datasets/ego4d/v2/full_scale --fps 2 --resolution 384

Shards the mp4 list across tasks (see sharding.py); each file runs through
ffmpeg once (aspect-preserving scale to max-side + center pad). Idempotent:
existing outputs are skipped (matching the reference's resumability pattern,
SURVEY.md §5).

A copy of ``videollm_online_tpu/data/preprocess/ffmpeg_job.py``: host work,
no framework."""

from __future__ import annotations

import argparse
import os
import pathlib

from ..video_io import ffmpeg_once
from .sharding import shard


def dst_root_for(src_root: str, fps, resolution) -> str:
    dst = src_root.rstrip("/")
    if fps is not None:
        dst += f"_{fps:g}fps"
    if resolution is not None:
        dst += f"_max{resolution}"
    return dst


def run(video_dir: str, fps=None, resolution=None, overwrite=False):
    src_root = video_dir.rstrip("/")
    dst_root = dst_root_for(src_root, fps, resolution)
    paths = [str(p) for p in pathlib.Path(src_root).rglob("*")
             if p.is_file() and str(p).endswith(".mp4")]
    done = 0
    for _, src in shard(sorted(paths)):
        dst = src.replace(src_root, dst_root)
        if os.path.exists(dst) and not overwrite:
            continue
        ffmpeg_once(src, dst, fps=fps, resolution=resolution)
        done += 1
    print(f"ffmpeg_job: processed {done} files -> {dst_root}")
    return dst_root


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--video_dir", required=True)
    p.add_argument("--fps", type=float, default=2.0)
    p.add_argument("--resolution", type=int, default=384)
    p.add_argument("--overwrite", action="store_true")
    a = p.parse_args(argv)
    run(a.video_dir, a.fps, a.resolution, a.overwrite)


if __name__ == "__main__":
    main()
