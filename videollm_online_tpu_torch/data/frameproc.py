"""ctypes binding for the native frame preprocessor (native/frameproc.cc).

A framework-free copy of ``videollm_online_tpu/data/frameproc.py``: the
same library, loaded by path, and the same numpy resize without it.

Replaces the ffmpeg-scaler + torchvision video_reader resize path
(data/utils.py:51-66): aspect-preserving resize to max-side ``resolution``
with center zero-padding, HWC uint8 -> CHW uint8, multithreaded on the host.
Pure-numpy fallback keeps it working without the compiled library."""

from __future__ import annotations

import ctypes
import os
import numpy as np

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    for cand in (os.environ.get("VLO_FRAMEPROC_LIB", ""),
                 os.path.join(here, "native", "build", "libframeproc.so")):
        if cand and os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.preprocess_frames.restype = None
            lib.preprocess_frames.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.c_int]
            _LIB = lib
            break
    return _LIB


def _resize_bilinear_np(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Half-pixel-center bilinear resize, matching the C++ kernel."""
    sh, sw = img.shape[:2]
    fy = (np.arange(th) + 0.5) * (sh / th) - 0.5
    fx = (np.arange(tw) + 0.5) * (sw / tw) - 0.5
    y0 = np.clip(fy.astype(np.int32), 0, sh - 1)
    x0 = np.clip(fx.astype(np.int32), 0, sw - 1)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = np.clip(fy - y0, 0, 1)[:, None, None]
    wx = np.clip(fx - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    top = img[y0][:, x0] + (img[y0][:, x1] - img[y0][:, x0]) * wx
    bot = img[y1][:, x0] + (img[y1][:, x1] - img[y1][:, x0]) * wx
    return (top + (bot - top) * wy + 0.5).astype(np.uint8)


def preprocess_frames(frames: np.ndarray, resolution: int,
                      num_threads: int = 8) -> np.ndarray:
    """(N, H, W, 3) uint8 HWC -> (N, 3, res, res) uint8 CHW (resized+padded)."""
    assert frames.ndim == 4 and frames.shape[-1] == 3 and frames.dtype == np.uint8
    n, sh, sw, _ = frames.shape
    lib = _native_lib()
    out = np.empty((n, 3, resolution, resolution), np.uint8)
    if lib is not None:
        frames = np.ascontiguousarray(frames)
        lib.preprocess_frames(
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, sh, sw,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), resolution,
            num_threads)
        return out
    # numpy fallback
    if sw >= sh:
        tw, th = resolution, max(1, sh * resolution // sw)
    else:
        th, tw = resolution, max(1, sw * resolution // sh)
    oy, ox = (resolution - th) // 2, (resolution - tw) // 2
    out[:] = 0
    for i in range(n):
        resized = _resize_bilinear_np(frames[i], th, tw)
        out[i, :, oy:oy + th, ox:ox + tw] = resized.transpose(2, 0, 1)
    return out
