"""First-party AVI (RIFF) container IO — a real video decode/mux path that
needs no external binary.

A framework-free copy of ``videollm_online_tpu/data/avi.py``, kept here so
the PyTorch port imports nothing of the JAX package.

The reference delegates every container touch to native dependencies: a
static ffmpeg binary for preprocessing (reference data/utils.py:51-66) and
torchvision's C++ video_reader for decode (data/utils.py:106-113,
demo/inference.py:112), and muxes demo renders with moviepy/ffmpeg
(demo/rendering/render.py:141-156). This module owns the container layer:
an AVI reader/writer supporting

  * video: raw DIB frames (``rawvideo`` — BGR24, bottom-up, 4-byte row
    alignment, the BITMAPINFOHEADER convention ffmpeg's ``-c:v rawvideo``
    uses inside AVI), and MJPEG (each frame a standalone JPEG; decoded and
    encoded through PIL's native JPEG codec),
  * audio: mono 16-bit PCM (``01wb`` chunks, WAVEFORMATEX header),
  * a standard ``idx1`` index so other tools (ffmpeg/ffprobe/VLC) accept
    the files we write.

Files written by ``ffmpeg -c:v rawvideo`` / ``-c:v mjpeg`` into ``.avi``
are readable here, and files written here are readable by ffmpeg — the
interop contract is the BMP/JPEG layouts above, not a private format.

Higher layers use this via data/video_io.py (decode + fps resample +
scale/pad without an ffmpeg binary) and serve/rendering.py (mux video +
TTS track without ffmpeg).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


# --------------------------------------------------------------------------
# low-level RIFF helpers
# --------------------------------------------------------------------------

def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) & 1 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def _iter_chunks(buf: bytes, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size); handles word alignment."""
    pos = start
    while pos + 8 <= end:
        fourcc = buf[pos:pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)


# --------------------------------------------------------------------------
# write
# --------------------------------------------------------------------------

def _encode_dib(frame_rgb: np.ndarray) -> bytes:
    """(H, W, 3) RGB -> bottom-up BGR rows padded to 4 bytes (BI_RGB)."""
    h, w, _ = frame_rgb.shape
    bgr = frame_rgb[::-1, :, ::-1]  # bottom-up, BGR
    stride = (w * 3 + 3) & ~3
    if stride == w * 3:
        return np.ascontiguousarray(bgr).tobytes()
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    return rows.tobytes()


def _encode_mjpeg(frame_rgb: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    bio = io.BytesIO()
    Image.fromarray(frame_rgb, "RGB").save(bio, "JPEG", quality=quality)
    return bio.getvalue()


def write_avi(path: str, frames: np.ndarray, fps: float, *,
              codec: str = "rawvideo",
              audio: Optional[Tuple[int, np.ndarray]] = None,
              jpeg_quality: int = 90) -> str:
    """Write (T, H, W, 3) uint8 RGB frames (+ optional mono PCM audio) to an
    AVI file.

    ``codec``: ``rawvideo`` (DIB, lossless) or ``mjpeg``.
    ``audio``: ``(sample_rate, waveform)`` — float in [-1, 1] or int16; the
    track is interleaved as one ``01wb`` chunk per video frame.
    """
    frames = np.asarray(frames)
    assert frames.ndim == 4 and frames.shape[-1] == 3 \
        and frames.dtype == np.uint8, "frames must be (T, H, W, 3) uint8"
    n, h, w, _ = frames.shape
    if codec == "rawvideo":
        handler, compression = b"DIB ", 0
        payloads = [_encode_dib(f) for f in frames]
        vid_ck = b"00db"
    elif codec == "mjpeg":
        handler = b"MJPG"
        compression = struct.unpack("<I", b"MJPG")[0]
        payloads = [_encode_mjpeg(f, jpeg_quality) for f in frames]
        vid_ck = b"00dc"
    else:
        raise ValueError(f"unsupported codec: {codec!r}")

    # fps as a rate/scale rational (exact for the usual 2/25/30/29.97 cases)
    scale = 1000
    rate = int(round(fps * scale))

    aud_pcm = None
    sr = 0
    if audio is not None:
        sr, wav = audio
        wav = np.asarray(wav)
        if wav.dtype != np.int16:
            wav = (np.clip(wav.astype(np.float32), -1, 1) * 32767) \
                .astype(np.int16)
        aud_pcm = wav

    # ---- headers ----------------------------------------------------------
    max_bytes = max(len(p) for p in payloads) if payloads else 0
    n_streams = 2 if aud_pcm is not None else 1
    avih = struct.pack(
        "<14I",
        int(1e6 / fps) if fps else 0,   # dwMicroSecPerFrame
        int(max_bytes * fps),           # dwMaxBytesPerSec (approx)
        0, _AVIF_HASINDEX, n, 0, n_streams, max_bytes, w, h, 0, 0, 0, 0)

    strh_v = struct.pack(
        "<4s4sIHHIIIIIIII4H",
        b"vids", handler, 0, 0, 0, 0, scale, rate, 0, n, max_bytes,
        0xFFFFFFFF, 0, 0, 0, w, h)
    strf_v = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24,
        struct.pack("<I", compression), len(payloads[0]) if payloads else 0,
        0, 0, 0, 0)
    strl_v = _list(b"strl", _chunk(b"strh", strh_v) + _chunk(b"strf", strf_v))

    strl_a = b""
    if aud_pcm is not None:
        n_samples = len(aud_pcm)
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIII4H",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0, 1, sr, 0, n_samples,
            sr * 2, 0xFFFFFFFF, 2, 0, 0, 0, 0)
        strf_a = struct.pack("<HHIIHHH", 1, 1, sr, sr * 2, 2, 16, 0)
        strl_a = _list(b"strl",
                       _chunk(b"strh", strh_a) + _chunk(b"strf", strf_a))

    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl_v + strl_a)

    # ---- movi + idx1 ------------------------------------------------------
    movi_body = b""
    idx_entries = []
    samples_per_frame = (len(aud_pcm) + n - 1) // n if aud_pcm is not None \
        else 0
    for i, payload in enumerate(payloads):
        idx_entries.append((vid_ck, len(movi_body) + 4, len(payload)))
        movi_body += _chunk(vid_ck, payload)
        if aud_pcm is not None:
            seg = aud_pcm[i * samples_per_frame:(i + 1) * samples_per_frame]
            blob = seg.astype("<i2").tobytes()
            idx_entries.append((b"01wb", len(movi_body) + 4, len(blob)))
            movi_body += _chunk(b"01wb", blob)
    movi = _list(b"movi", movi_body)

    idx1 = b"".join(
        ck + struct.pack("<III", _AVIIF_KEYFRAME, off, size)
        for ck, off, size in idx_entries)
    riff_body = b"AVI " + hdrl + movi + _chunk(b"idx1", idx1)

    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return path


# --------------------------------------------------------------------------
# read
# --------------------------------------------------------------------------

@dataclass
class AviData:
    frames: np.ndarray            # (T, H, W, 3) uint8 RGB
    fps: float
    audio: Optional[np.ndarray]   # int16 mono, or None
    sample_rate: int = 0

    @property
    def duration(self) -> float:
        return len(self.frames) / self.fps if self.fps else 0.0


def _decode_dib(payload: bytes, w: int, h: int,
                bottom_up: bool = True) -> np.ndarray:
    stride = (w * 3 + 3) & ~3
    rows = np.frombuffer(payload[: stride * h], np.uint8).reshape(h, stride)
    bgr = rows[:, : w * 3].reshape(h, w, 3)
    if bottom_up:  # positive biHeight = bottom-up (the BMP default)
        bgr = bgr[::-1]
    return bgr[:, :, ::-1].copy()  # -> top-down RGB


# JPEG Annex-K default Huffman tables. MJPEG streams are allowed to omit
# DHT segments entirely ("AVI1" table-less frames — the encoder assumes the
# decoder knows the standard tables; ffmpeg's MJPEG decoder splices these
# same tables). Layout per table: Tc/Th byte, 16 BITS counts, then values.
_DHT_DC_LUM = bytes([0x00,
    0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]) + bytes(range(12))
_DHT_DC_CHR = bytes([0x01,
    0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]) + bytes(range(12))
_DHT_AC_LUM = bytes([0x10,
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]) + bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])
_DHT_AC_CHR = bytes([0x11,
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]) + bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])


def _default_dht_segment() -> bytes:
    body = _DHT_DC_LUM + _DHT_AC_LUM + _DHT_DC_CHR + _DHT_AC_CHR
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def _splice_dht(jpeg: bytes, dht: bytes) -> bytes:
    """If ``jpeg`` carries no DHT segment, insert ``dht`` before SOS.

    Walks the marker-segment chain from SOI; standalone markers (TEM, RSTn)
    have no length field. Returns the input unchanged when a DHT exists or
    the stream is malformed (let PIL surface the real error)."""
    if jpeg[:2] != b"\xff\xd8":
        return jpeg
    pos = 2
    while pos + 4 <= len(jpeg):
        if jpeg[pos] != 0xFF:
            return jpeg
        marker = jpeg[pos + 1]
        if marker == 0xC4:                       # DHT already present
            return jpeg
        if marker == 0xDA:                       # SOS: entropy data follows
            return jpeg[:pos] + dht + jpeg[pos:]
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2                             # standalone marker
            continue
        (seglen,) = struct.unpack_from(">H", jpeg, pos + 2)
        pos += 2 + seglen
    return jpeg


def _extradata_dht(strf: bytes) -> Optional[bytes]:
    """AVI1 convention: Huffman tables for table-less frames travel in the
    strf extradata (bytes past the 40-byte BITMAPINFOHEADER). Accepts either
    a full marker-framed DHT segment or bare table payload."""
    extra = strf[40:]
    if len(extra) < 20:
        return None
    k = extra.find(b"\xff\xc4")
    if k >= 0:
        if k + 4 > len(extra):
            return None
        (seglen,) = struct.unpack_from(">H", extra, k + 2)
        seg = extra[k:k + 2 + seglen]
        return seg if len(seg) == 2 + seglen else None
    # Bare tables (no marker): frame them as one DHT segment.
    return b"\xff\xc4" + struct.pack(">H", len(extra) + 2) + extra


def _decode_jpeg(payload: bytes, dht: Optional[bytes] = None) -> np.ndarray:
    from PIL import Image
    jpeg = _splice_dht(payload, dht or _default_dht_segment())
    img = Image.open(io.BytesIO(jpeg))
    return np.asarray(img.convert("RGB"))


def _parse_headers(buf: bytes, start: int, end: int):
    """Parse LIST hdrl -> per-stream {type, handler, rate, scale, strf}."""
    streams = []
    for fourcc, p, size in _iter_chunks(buf, start, end):
        if fourcc == b"LIST" and buf[p:p + 4] == b"strl":
            info = {}
            for cc2, p2, s2 in _iter_chunks(buf, p + 4, p + size):
                if cc2 == b"strh":
                    info["type"] = buf[p2:p2 + 4]
                    info["handler"] = buf[p2 + 4:p2 + 8]
                    info["scale"], info["rate"] = \
                        struct.unpack_from("<II", buf, p2 + 20)
                elif cc2 == b"strf":
                    info["strf"] = buf[p2:p2 + s2]
            streams.append(info)
    return streams


def read_avi(path: str, *, with_audio: bool = False) -> AviData:
    """Parse an AVI file. Raw-DIB and MJPEG video; mono/stereo 16-bit PCM
    audio (stereo is downmixed)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"RIFF" or buf[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")

    streams, movi_span = [], None
    for fourcc, p, size in _iter_chunks(buf, 12, len(buf)):
        if fourcc == b"LIST" and buf[p:p + 4] == b"hdrl":
            streams = _parse_headers(buf, p + 4, p + size)
        elif fourcc == b"LIST" and buf[p:p + 4] == b"movi":
            movi_span = (p + 4, p + size)
    if movi_span is None or not streams:
        raise ValueError(f"{path}: missing movi/hdrl")

    vstream = next((i for i, s in enumerate(streams)
                    if s.get("type") == b"vids"), None)
    astream = next((i for i, s in enumerate(streams)
                    if s.get("type") == b"auds"), None)
    if vstream is None:
        raise ValueError(f"{path}: no video stream")
    v = streams[vstream]
    _, w, h, _, bitcount = struct.unpack_from("<IiiHH", v["strf"], 0)
    compression = v["strf"][16:20]
    bottom_up = h > 0
    h = abs(h)
    fps = v["rate"] / v["scale"] if v["scale"] else 0.0

    sr, channels = 0, 1
    if astream is not None:
        fmt, channels, sr = struct.unpack_from("<HHI", streams[astream]["strf"])
        if fmt != 1:
            astream = None  # only PCM supported

    frames, audio_parts = [], []
    raw_dib = compression in (b"\x00\x00\x00\x00",) and bitcount == 24
    mjpeg = compression in (b"MJPG", b"mjpg", b"AVI1", b"dmb1")
    dht = _extradata_dht(v["strf"]) if mjpeg else None
    for fourcc, p, size in _iter_chunks(buf, *movi_span):
        if fourcc == b"LIST":  # 'rec ' interleave groups
            for cc2, p2, s2 in _iter_chunks(buf, p + 4, p + size):
                _collect(buf, cc2, p2, s2, vstream, astream, raw_dib, mjpeg,
                         w, h, bottom_up, frames, audio_parts, dht)
        else:
            _collect(buf, fourcc, p, size, vstream, astream, raw_dib, mjpeg,
                     w, h, bottom_up, frames, audio_parts, dht)

    if not raw_dib and not mjpeg and frames == []:
        raise ValueError(
            f"{path}: unsupported video codec {compression!r} "
            "(first-party reader handles rawvideo DIB and MJPEG)")
    video = np.stack(frames) if frames else \
        np.zeros((0, h, w, 3), np.uint8)

    audio = None
    if with_audio and audio_parts:
        audio = np.frombuffer(b"".join(audio_parts), "<i2")
        if channels > 1:
            audio = audio.reshape(-1, channels).mean(axis=1).astype(np.int16)
    return AviData(frames=video, fps=fps, audio=audio, sample_rate=sr)


def _collect(buf, fourcc, p, size, vstream, astream, raw_dib, mjpeg, w, h,
             bottom_up, frames, audio_parts, dht=None):
    try:
        sid = int(fourcc[:2])
    except ValueError:
        return
    kind = fourcc[2:4]
    payload = buf[p:p + size]
    if sid == vstream and kind in (b"db", b"dc") and size > 0:
        if raw_dib:
            frames.append(_decode_dib(payload, w, h, bottom_up))
        elif mjpeg:
            frames.append(_decode_jpeg(payload, dht))
    elif astream is not None and sid == astream and kind == b"wb":
        audio_parts.append(payload)


def probe_avi(path: str) -> dict:
    """Header-only probe: duration/fps/frame count/dims/audio presence."""
    with open(path, "rb") as f:
        head = f.read(16384)
    if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI file")
    streams = []
    n_frames = w = h = 0
    for fourcc, p, size in _iter_chunks(head, 12, len(head)):
        if fourcc == b"LIST" and head[p:p + 4] == b"hdrl":
            (n_frames,) = struct.unpack_from("<I", head, p + 4 + 8 + 16)
            w, h = struct.unpack_from("<II", head, p + 4 + 8 + 32)
            streams = _parse_headers(head, p + 4, p + size)
            break
    v = next((s for s in streams if s.get("type") == b"vids"), None)
    fps = (v["rate"] / v["scale"]) if v and v["scale"] else 0.0
    # strh dwLength is per-stream frame count; prefer it when present
    return {
        "n_frames": n_frames, "fps": fps, "width": w, "height": h,
        "duration": n_frames / fps if fps else 0.0,
        "has_audio": any(s.get("type") == b"auds" for s in streams),
    }
