"""The port's copies of the JAX package's host video IO, held to the
originals: ``data/avi.py`` (the bytes a writer makes, with and without a
PCM audio track, the frames, audio and header a reader returns),
``data/frameproc.py`` (the resize and pad) and ``data/video_io.py`` (the
fps grid, the no-ffmpeg ``.avi`` path, the arrays and the errors)."""

import numpy as np
import pytest

from videollm_online_tpu.data import avi as jax_avi
from videollm_online_tpu.data import frameproc as jax_frameproc
from videollm_online_tpu.data import video_io as jax_video_io

from videollm_online_tpu_torch.data import avi, frameproc, video_io


def _gradient_frames(n, h, w):
    y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
    out = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        out[i, :, :, 0] = ((y + 7 * i) % 256).astype(np.uint8)
        out[i, :, :, 1] = ((x + 13 * i) % 256).astype(np.uint8)
        out[i, :, :, 2] = np.uint8(40 * i % 256)
    return out


@pytest.mark.parametrize("codec,audio", [("rawvideo", False),
                                         ("rawvideo", True),
                                         ("mjpeg", False)])
def test_avi_bytes_and_frames_equal_jax(tmp_path, codec, audio):
    """The port writes the JAX writer's bytes and reads its files; with an
    interleaved PCM audio track too, which each reader skips unless asked
    for it and then returns as the other does."""
    frames = (_gradient_frames(5, 36, 50) if codec == "mjpeg" else
              np.random.RandomState(0).randint(0, 256, (5, 36, 50, 3),
                                               dtype=np.uint8))
    mine, theirs = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    track = {"audio": (8000, (np.sin(np.arange(20000) * 0.05) * 0.5)
                       .astype(np.float32))} if audio else {}
    avi.write_avi(mine, frames, 2.0, codec=codec, **track)
    jax_avi.write_avi(theirs, frames, 2.0, codec=codec, **track)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    if audio:
        got = avi.read_avi(theirs, with_audio=True)
        want = jax_avi.read_avi(mine, with_audio=True)
        np.testing.assert_array_equal(got.audio, want.audio)
        assert got.sample_rate == want.sample_rate == 8000
        assert len(got.audio) == 20000
    got = avi.read_avi(theirs)
    want = jax_avi.read_avi(mine)
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.fps, got.duration) == (want.fps, want.duration)
    if codec == "rawvideo":
        np.testing.assert_array_equal(got.frames, frames)
    assert avi.probe_avi(mine) == jax_avi.probe_avi(mine)


@pytest.mark.parametrize("shape,res", [((3, 48, 96, 3), 64),
                                       ((2, 90, 40, 3), 32),
                                       ((1, 17, 17, 3), 384)])
def test_frameproc_equals_jax(shape, res):
    frames = np.random.RandomState(1).randint(0, 256, shape, dtype=np.uint8)
    got = frameproc.preprocess_frames(frames, res)
    np.testing.assert_array_equal(got, jax_frameproc.preprocess_frames(
        frames, res))
    assert got.shape == (shape[0], 3, res, res)
    img = frames[0]
    np.testing.assert_array_equal(
        frameproc._resize_bilinear_np(img, 11, 23),
        jax_frameproc._resize_bilinear_np(img, 11, 23))


def test_video_io_equals_jax(tmp_path, monkeypatch):
    for n, src, dst in ((60, 30, 2), (4, 2, 4), (5, 2, 2), (0, 2, 2),
                        (7, 0, 2), (31, 29.97, 2)):
        np.testing.assert_array_equal(
            video_io.resample_frame_indices(n, src, dst),
            jax_video_io.resample_frame_indices(n, src, dst))
    assert video_io._scale_pad_filter(384) == \
        jax_video_io._scale_pad_filter(384)
    # the no-ffmpeg .avi path: decode, fps resample, scale and pad
    monkeypatch.setattr(video_io, "_FFMPEG", "")
    monkeypatch.setattr(jax_video_io, "_FFMPEG", "")
    p = str(tmp_path / "v.avi")
    avi.write_avi(p, _gradient_frames(30, 48, 96), fps=3.0)
    got = video_io.read_video_frames(p, fps=1.0, resolution=64)
    assert got.shape == (10, 3, 64, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jax_video_io.read_video_frames(p, fps=1.0, resolution=64))
    # arrays pass through
    arr = np.random.RandomState(2).randn(3, 10, 8).astype(np.float32)
    for ext in ("npy", "pt"):
        f = str(tmp_path / f"x.{ext}")
        jax_video_io.save_array(f, arr)
        np.testing.assert_array_equal(video_io.read_video_frames(f), arr)
        np.testing.assert_array_equal(jax_video_io.load_array(f), arr)
    # and an mp4 without a decoder says what to do
    with pytest.raises(RuntimeError, match="H.264") as ei:
        video_io.read_video_frames(str(tmp_path / "nope.mp4"))
    assert "FFMPEG_BINARY" in str(ei.value)
