"""Offline demo-video renderer: composite a streamed conversation onto the
video with chat boards, optional TTS, and mux the result.

Equivalent of reference demo/rendering/render.py: PIL text boards drawn
next to the frames with per-message timing from the conversation JSON
(render.py:31-75), speech synthesis per assistant message (ChatTTS with
fixed speaker seeds, render.py:12-29), and a final mux (moviepy,
render.py:141-156). This environment has PIL but no ChatTTS/moviepy:
the TTS backend is pluggable (``tts_fn(text) -> (sr, waveform)`` or None;
``serve.tts.default_tts_fn()`` provides a dependency-free offline formant
synthesizer with deterministic speaker seeds) and muxing shells out to
ffmpeg when present; otherwise (or for .avi outputs) the first-party AVI
muxer (data/avi.py) writes a playable MJPEG video with the TTS track as
interleaved PCM audio — no external binary needed.

A copy of ``videollm_online_tpu/serve/rendering.py``; PIL is imported only
when a frame is composed."""

from __future__ import annotations

import json
import os
import subprocess
from typing import Callable, List, Optional, Tuple

import numpy as np

BOARD_WIDTH = 512
MARGIN = 12
USER_COLOR = (64, 128, 255)
ASSISTANT_COLOR = (32, 200, 96)
BG = (20, 20, 24)


def _wrap(draw, font, text: str, width: int) -> List[str]:
    words = text.split()
    lines, cur = [], ""
    for w in words:
        cand = (cur + " " + w).strip()
        if draw.textlength(cand, font=font) <= width:
            cur = cand
        else:
            if cur:
                lines.append(cur)
            cur = w
    if cur:
        lines.append(cur)
    return lines


def compose_frame(frame_chw: np.ndarray, messages: List[dict]) -> np.ndarray:
    """One video frame (3, H, W uint8) + visible messages -> frame with a
    chat board on the right (HWC uint8)."""
    from PIL import Image, ImageDraw, ImageFont

    frame = Image.fromarray(frame_chw.transpose(1, 2, 0))
    H = frame.height
    board = Image.new("RGB", (BOARD_WIDTH, H), BG)
    draw = ImageDraw.Draw(board)
    font = ImageFont.load_default(size=16)
    y = MARGIN
    for m in messages:
        color = USER_COLOR if m["role"] == "user" else ASSISTANT_COLOR
        head = f'[{m.get("time", 0):.1f}s] {m["role"].capitalize()}:'
        draw.text((MARGIN, y), head, fill=color, font=font)
        y += 22
        for line in _wrap(draw, font, m["content"], BOARD_WIDTH - 2 * MARGIN):
            if y > H - 24:
                break
            draw.text((MARGIN, y), line, fill=(230, 230, 230), font=font)
            y += 20
        y += 8
        if y > H - 24:
            break
    out = Image.new("RGB", (frame.width + BOARD_WIDTH, H))
    out.paste(frame, (0, 0))
    out.paste(board, (frame.width, 0))
    return np.asarray(out)


def render_conversation_video(
    frames_chw: np.ndarray,
    conversation: List[dict],
    out_path: str,
    *,
    fps: float = 2.0,
    tts_fn: Optional[Callable[[str], Tuple[int, np.ndarray]]] = None,
    max_visible: int = 6,
) -> str:
    """frames (T, 3, H, W) uint8 + [{'role','content','time'}...] ->
    rendered video (ffmpeg) or composited frame stack (.npy fallback)."""
    T = frames_chw.shape[0]
    rendered = []
    for t in range(T):
        now = t / fps
        visible = [m for m in conversation if m.get("time", 0) <= now]
        rendered.append(compose_frame(frames_chw[t], visible[-max_visible:]))
    video = np.stack(rendered)  # (T, H, W', 3)

    from ..data.video_io import find_ffmpeg
    ffmpeg = find_ffmpeg()
    if ffmpeg is None or out_path.endswith(".avi"):
        # First-party mux: MJPEG AVI with the TTS track as interleaved PCM
        # (data/avi.py) — a real playable container, no external binary.
        avi_path = os.path.splitext(out_path)[0] + ".avi"
        audio = None
        if tts_fn is not None:
            sr, track = _compose_tts_track(conversation, tts_fn,
                                           video.shape[0] / fps)
            audio = (sr, track)
        from ..data.avi import write_avi
        write_avi(avi_path, video, fps, codec="mjpeg", audio=audio)
        return avi_path

    Tn, H, W, _ = video.shape
    cmd = [ffmpeg, "-y", "-loglevel", "error",
           "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{W}x{H}",
           "-r", f"{fps}", "-i", "pipe:0"]
    audio_path = None
    if tts_fn is not None:
        audio_path = _render_tts_track(conversation, tts_fn, T / fps,
                                       os.path.splitext(out_path)[0] + ".wav")
        cmd += ["-i", audio_path, "-c:a", "aac", "-shortest"]
    cmd += ["-pix_fmt", "yuv420p", out_path]
    proc = subprocess.run(cmd, input=video.tobytes(), check=True)
    return out_path


def _compose_tts_track(conversation, tts_fn, duration_s: float):
    """Place each assistant message's synthesized speech at its timestamp."""
    sr = None
    clips = []
    for m in conversation:
        if m["role"] != "assistant":
            continue
        rate, wav = tts_fn(m["content"])
        sr = sr or rate
        clips.append((m.get("time", 0.0), np.asarray(wav, np.float32)))
    sr = sr or 16000
    track = np.zeros(int(duration_s * sr) + sr, np.float32)
    for t, wav in clips:
        start = int(t * sr)
        end = min(start + len(wav), len(track))
        track[start:end] += wav[: end - start]
    return sr, np.clip(track, -1, 1)


def _render_tts_track(conversation, tts_fn, duration_s: float,
                      wav_path: str) -> str:
    import wave

    sr, track = _compose_tts_track(conversation, tts_fn, duration_s)
    with wave.open(wav_path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((track * 32767).astype(np.int16).tobytes())
    return wav_path


def render_from_history(history_json: str, video: np.ndarray, out_path: str,
                        **kw) -> str:
    """Render from a serve.cli history dump (cli.py --output)."""
    with open(history_json) as f:
        hist = json.load(f)
    conversation = []
    for m in hist["messages"]:
        text = m["content"]
        time_s = 0.0
        if "(Video Time = " in text:
            time_s = float(text.split("(Video Time = ")[1].split("s)")[0])
            text = text.split(") ", 1)[1] if ") " in text else text
        conversation.append({"role": m["role"], "content": text,
                             "time": time_s})
    return render_conversation_video(video, conversation, out_path, **kw)
