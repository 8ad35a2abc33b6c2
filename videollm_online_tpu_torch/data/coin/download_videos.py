"""COIN video downloader with verify/re-download fault handling.

Re-implements the reference tool (data/coin/download_videos.py:1-45):
fetch every video in the COIN annotation JSON with yt-dlp, in a thread
pool; files that already exist are integrity-checked by a full ffmpeg
null-decode and re-downloaded if broken (the fault-handling pattern
SURVEY.md §5 calls out). Usage:

    python -m videollm_online_tpu_torch.data.coin.download_videos \
        --output_dir datasets/coin/videos --json_path datasets/coin/coin.json

Network tools (yt-dlp, ffmpeg) are host-side subprocesses; nothing here
touches the accelerator. Errors are collected per-video instead of crashing
the pool, and a summary is printed so a re-run can pick up the failures
(downloads are idempotent: verified files are skipped).

A copy of ``videollm_online_tpu/data/coin/download_videos.py``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import random
import subprocess
from typing import List, Optional, Tuple


def _ffmpeg_bin(ffmpeg_location: Optional[str]) -> str:
    return (os.path.join(ffmpeg_location, "ffmpeg")
            if ffmpeg_location else "ffmpeg")


def verify_video(path: str, ffmpeg_location: Optional[str] = None) -> bool:
    """Full-decode integrity check (`ffmpeg -v error -i X -f null -`,
    reference download_videos.py:12-15). Returns False on any decode error."""
    try:
        subprocess.run(
            [_ffmpeg_bin(ffmpeg_location), "-v", "error", "-i", path,
             "-f", "null", "-"],
            check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def download_video(video_id: str, video_url: str, output_dir: str,
                   ffmpeg_location: Optional[str] = None) -> Tuple[str, str]:
    """Download one video; returns (video_id, status) where status is one of
    'verified' (existing file passed the check), 'downloaded', or an error
    message. Broken existing files are removed and re-fetched
    (reference download_videos.py:10-19)."""
    output_path = os.path.join(output_dir, f"{video_id}.mp4")
    if os.path.exists(output_path):
        if verify_video(output_path, ffmpeg_location):
            return video_id, "verified"
        os.remove(output_path)
    cmd = ["yt-dlp", "--username", "oauth2", "--password", "",
           "-f", "mp4", "-o", output_path, video_url]
    if ffmpeg_location:
        cmd.extend(["--ffmpeg-location", ffmpeg_location])
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        return video_id, "downloaded"
    except FileNotFoundError:
        return video_id, "error: yt-dlp not installed"
    except subprocess.CalledProcessError as e:
        tail = (e.stderr or "").strip().splitlines()
        return video_id, f"error: {tail[-1] if tail else e.returncode}"


def download_all(output_dir: str, json_path: str, num_workers: int = 16,
                 ffmpeg_location: Optional[str] = None,
                 ) -> List[Tuple[str, str]]:
    """Download every video in the COIN annotation database (shuffled so
    parallel re-runs spread over the remaining work). Returns the per-video
    (id, status) list."""
    with open(json_path) as f:
        annotations = list(json.load(f)["database"].items())
    random.shuffle(annotations)
    os.makedirs(output_dir, exist_ok=True)
    results: List[Tuple[str, str]] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_workers) as ex:
        futures = [
            ex.submit(download_video, vid, ann["video_url"], output_dir,
                      ffmpeg_location)
            for vid, ann in annotations]
        for fut in concurrent.futures.as_completed(futures):
            vid, status = fut.result()
            print(f"{vid}: {status}")
            results.append((vid, status))
    errors = [(v, s) for v, s in results if s.startswith("error")]
    print(f"done: {len(results) - len(errors)} ok, {len(errors)} failed"
          + (" (re-run to retry failures)" if errors else ""))
    return results


def main():
    parser = argparse.ArgumentParser(
        description="Download COIN videos in parallel using yt-dlp")
    parser.add_argument("--output_dir", type=str,
                        default="datasets/coin/videos")
    parser.add_argument("--json_path", type=str,
                        default="datasets/coin/coin.json")
    parser.add_argument("--ffmpeg", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=16)
    args = parser.parse_args()
    download_all(args.output_dir, args.json_path, args.num_workers,
                 args.ffmpeg)


if __name__ == "__main__":
    main()
