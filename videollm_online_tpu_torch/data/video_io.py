"""Host-side video IO: decode, fps-resample, scale+pad — CPU work feeding
device buffers.

A framework-free copy of ``videollm_online_tpu/data/video_io.py``.

The reference shells out to a static ffmpeg binary for preprocessing
(data/utils.py:51-66: fps resample + aspect-preserving scale to
``resolution`` max-side + center zero-pad to square) and uses torchvision's
C++ video_reader for decode (data/utils.py:106-113, demo/inference.py:112).
This stays host-CPU work: we keep the ffmpeg-subprocess design
(it is I/O-side, not accelerator work — SURVEY.md §2.2) and read raw frames
over a pipe; pre-extracted feature files (.npy/.npz/.pt) bypass decode
entirely, which is how training/eval always runs (features are pre-extracted,
data/utils.py:86-104).

Without an ffmpeg binary, ``.avi`` containers (rawvideo DIB / MJPEG) decode
through the first-party RIFF parser (data/avi.py) with the same fps-resample
and scale/pad semantics applied host-side (fps grid: ffmpeg's ``fps=``
filter picks, for each output timestamp k/fps_out, the nearest input frame;
scale/pad: frameproc's aspect-preserving resize + center zero-pad).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_FFMPEG = None


def find_ffmpeg() -> Optional[str]:
    global _FFMPEG
    if _FFMPEG is None:
        _FFMPEG = (os.environ.get("FFMPEG_BINARY")
                   or shutil.which("ffmpeg") or "")
    return _FFMPEG or None


def _no_ffmpeg_message(path: str) -> str:
    """Actionable error for compressed containers the first-party reader
    cannot touch. The reference corpus is H.264 mp4 (data/utils.py:106-113);
    inter-frame codecs need a real decoder binary — there is no no-binary
    story for them, only transcode-ahead-of-time."""
    kind = "video"
    try:
        with open(path, "rb") as f:
            head = f.read(12)
        if head[4:8] == b"ftyp":
            kind = "an ISO-BMFF (mp4/mov, typically H.264/H.265) video"
        elif head[:4] == b"\x1a\x45\xdf\xa3":
            kind = "a Matroska/WebM video"
    except OSError:
        pass
    if path.endswith((".mp4", ".mov", ".m4v")):
        kind = "an mp4 (typically H.264/H.265) video"
    elif path.endswith((".mkv", ".webm")):
        kind = "a Matroska/WebM video"
    return (
        f"cannot decode {path}: it is {kind} and no ffmpeg binary exists in "
        "this environment. Inter-frame codecs (H.264/H.265/VP9) require a "
        "real decoder; the first-party reader (data/avi.py) handles only "
        "rawvideo-DIB and MJPEG inside .avi. Fix: set FFMPEG_BINARY to an "
        "ffmpeg build, or transcode once where ffmpeg exists "
        "(`ffmpeg -i in.mp4 -c:v mjpeg out.avi`), or provide pre-extracted "
        "features as .npy/.pt (how training/eval normally runs).")


def _scale_pad_filter(resolution: int) -> str:
    """Aspect-preserving scale to max-side ``resolution`` + center zero-pad
    to a square (mirrors data/utils.py:51-66)."""
    r = resolution
    return (f"scale=w={r}:h={r}:force_original_aspect_ratio=decrease,"
            f"pad={r}:{r}:(ow-iw)/2:(oh-ih)/2:color=black")


def resample_frame_indices(n_frames: int, src_fps: float,
                           dst_fps: float) -> np.ndarray:
    """Frame indices selected by an fps resample (ffmpeg ``fps=dst`` filter
    semantics, round=near): output slot k at time k/dst takes the input
    frame nearest to that timestamp; duration is preserved (dup/drop)."""
    if src_fps <= 0 or dst_fps <= 0 or n_frames == 0:
        return np.arange(n_frames)
    n_out = max(1, int(np.ceil(n_frames * dst_fps / src_fps - 1e-9)))
    idx = np.floor(np.arange(n_out) * src_fps / dst_fps + 0.5).astype(np.int64)
    return np.clip(idx, 0, n_frames - 1)


def _avi_read_preprocessed(path: str, fps: Optional[float],
                           resolution: Optional[int]) -> np.ndarray:
    """First-party .avi decode + fps resample + scale/pad -> (T,3,R,R)."""
    from . import avi
    from .frameproc import preprocess_frames
    data = avi.read_avi(path)
    frames = data.frames  # (T, H, W, 3) RGB
    if fps is not None and data.fps:
        frames = frames[resample_frame_indices(len(frames), data.fps, fps)]
    return preprocess_frames(np.ascontiguousarray(frames), resolution or 384)


def ffmpeg_once(src_path: str, dst_path: str, *, fps: Optional[float] = None,
                resolution: Optional[int] = None) -> None:
    """Resample + resize a video file once (reference data/utils.py:51-66).

    Falls back to the first-party AVI pipeline (decode -> fps resample ->
    scale/pad -> rawvideo AVI) when no ffmpeg binary exists and both ends
    are .avi."""
    ffmpeg = find_ffmpeg()
    if not ffmpeg and src_path.endswith(".avi") and dst_path.endswith(".avi"):
        from . import avi
        src = avi.read_avi(src_path)
        frames = src.frames
        out_fps = fps if fps is not None else (src.fps or 1.0)
        if fps is not None and src.fps:
            frames = frames[resample_frame_indices(len(frames), src.fps, fps)]
        if resolution is not None:
            from .frameproc import preprocess_frames
            chw = preprocess_frames(np.ascontiguousarray(frames), resolution)
            frames = np.ascontiguousarray(chw.transpose(0, 2, 3, 1))
        os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
        avi.write_avi(dst_path, frames, out_fps)
        return
    if not ffmpeg:
        raise RuntimeError(_no_ffmpeg_message(src_path))
    os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-i", src_path]
    filters = []
    if fps is not None:
        filters.append(f"fps={fps}")
    if resolution is not None:
        filters.append(_scale_pad_filter(resolution))
    if filters:
        cmd += ["-vf", ",".join(filters)]
    cmd += [dst_path]
    subprocess.run(cmd, check=True)


def read_video_frames(path: str, *, fps: Optional[float] = None,
                      resolution: Optional[int] = None) -> np.ndarray:
    """Decode to (T, 3, H, W) uint8. Feature/array files pass through."""
    if path.endswith((".npy", ".npz", ".pt")):
        return load_array(path)
    ffmpeg = find_ffmpeg()
    if not ffmpeg:
        if path.endswith(".avi"):
            return _avi_read_preprocessed(path, fps, resolution)
        raise RuntimeError(_no_ffmpeg_message(path))
    res = resolution or 384
    filters = []
    if fps is not None:
        filters.append(f"fps={fps}")
    filters.append(_scale_pad_filter(res))
    cmd = [ffmpeg, "-loglevel", "error", "-i", path,
           "-vf", ",".join(filters),
           "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1"]
    raw = subprocess.run(cmd, check=True, capture_output=True).stdout
    n = len(raw) // (res * res * 3)
    frames = np.frombuffer(raw[: n * res * res * 3], np.uint8)
    return frames.reshape(n, res, res, 3).transpose(0, 3, 1, 2)


def load_array(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        z = np.load(path)
        return z[list(z.keys())[0]]
    if path.endswith(".pt"):
        import torch
        t = torch.load(path, weights_only=True, map_location="cpu")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    raise ValueError(f"unsupported array file: {path}")


def save_array(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, arr)
    elif path.endswith(".pt"):
        import torch
        torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path)
    else:
        raise ValueError(f"unsupported array file: {path}")


def probe_duration(path: str) -> float:
    ffprobe = shutil.which("ffprobe")
    if not ffprobe:
        if path.endswith(".avi"):
            from . import avi
            return avi.probe_avi(path)["duration"]
        raise RuntimeError("ffprobe not available")
    out = subprocess.run(
        [ffprobe, "-v", "error", "-print_format", "json", "-show_format", path],
        check=True, capture_output=True).stdout
    return float(json.loads(out)["format"]["duration"])
