"""Offline formant-synthesis TTS backend for the demo-video renderer.

The reference renderer synthesizes per-message speech with ChatTTS using
fixed speaker seeds (demo/rendering/render.py:12-29,146-151). ChatTTS is a
heavyweight neural model that is not available in this environment, so this
module provides a dependency-free classical backend with the same plug
contract (``tts_fn(text) -> (sample_rate, float32 waveform)``):

  * rule-based grapheme -> phoneme mapping (vowels/consonant classes);
  * each phoneme drives a two-formant source-filter synthesizer — a
    glottal pulse train (voiced) or white noise (fricatives) shaped by two
    resonant frequencies, with pitch declination across the utterance;
  * the ``seed`` fixes the speaker (base pitch, formant scaling, speaking
    rate) deterministically — the counterpart of ChatTTS's sampled speaker
    embeddings with fixed torch seeds.

The output is intelligible robotic speech, not natural speech — enough for
offline demo videos and for exercising the full mux pipeline; swap in any
neural backend (e.g. ChatTTS behind the same callable) where available.

A copy of ``videollm_online_tpu/serve/tts.py`` (numpy only).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SAMPLE_RATE = 16000

# coarse formant targets (F1, F2) in Hz per phoneme class
_VOWELS: Dict[str, Tuple[float, float]] = {
    "a": (730, 1090), "e": (530, 1840), "i": (270, 2290),
    "o": (570, 840), "u": (300, 870), "y": (270, 2100),
}
_NASALS = {"m": (250, 1000), "n": (250, 1700)}
_FRICS = {"s": 5000.0, "z": 4000.0, "f": 3500.0, "v": 2500.0,
          "h": 1500.0, "x": 3000.0, "c": 4500.0, "j": 2500.0}
_STOPS = set("pbtdkgq")
_LIQUIDS = {"l": (360, 1300), "r": (310, 1060), "w": (290, 610)}


class FormantTTS:
    """Deterministic speaker: ``FormantTTS(seed)(text) -> (sr, wave)``."""

    def __init__(self, seed: int = 2, sample_rate: int = SAMPLE_RATE):
        rng = np.random.RandomState(seed)
        self.sr = sample_rate
        self.pitch = float(rng.uniform(95.0, 220.0))       # base F0
        self.formant_scale = float(rng.uniform(0.9, 1.15))  # vocal tract
        self.rate = float(rng.uniform(0.85, 1.1))            # speaking rate
        self.seed = seed

    # -- phoneme synthesis ---------------------------------------------------
    def _tone(self, dur: float, f1: float, f2: float, f0: float,
              amp: float = 0.5) -> np.ndarray:
        n = max(int(dur * self.sr), 1)
        t = np.arange(n) / self.sr
        # glottal source: pulse train approximated by harmonic stack
        src = np.zeros(n)
        for h in range(1, 9):
            src += np.sin(2 * np.pi * f0 * h * t) / h
        # two formant "resonances" as amplitude-modulated carriers
        w = (0.7 * np.sin(2 * np.pi * f1 * self.formant_scale * t)
             + 0.4 * np.sin(2 * np.pi * f2 * self.formant_scale * t))
        out = amp * src / 2.2 * (0.6 + 0.4 * (w * 0.5 + 0.5))
        return out * _envelope(n)

    def _noise(self, dur: float, center: float, amp: float = 0.25
               ) -> np.ndarray:
        n = max(int(dur * self.sr), 1)
        rng = np.random.RandomState(self.seed * 7919 + int(center))
        x = rng.randn(n)
        # crude band emphasis: difference filter tuned by the center freq
        k = max(int(self.sr / (2 * center)), 1)
        x = x - np.concatenate([np.zeros(k), x[:-k]])
        x = x / (np.max(np.abs(x)) + 1e-6)
        return amp * x * _envelope(n)

    def _silence(self, dur: float) -> np.ndarray:
        return np.zeros(max(int(dur * self.sr), 1), np.float64)

    # -- text front end -------------------------------------------------------
    def __call__(self, text: str) -> Tuple[int, np.ndarray]:
        chunks = []
        chars = [c for c in text.lower() if c.isalpha() or c in " .,!?"]
        n_voiced = max(sum(c.isalpha() for c in chars), 1)
        i = 0
        f0 = self.pitch * 1.12  # start high, decline across the utterance
        step = (self.pitch * 0.24) / n_voiced
        base = 0.085 / self.rate
        for c in chars:
            if c in _VOWELS:
                f1, f2 = _VOWELS[c]
                chunks.append(self._tone(base * 1.6, f1, f2, f0))
            elif c in _NASALS:
                f1, f2 = _NASALS[c]
                chunks.append(self._tone(base, f1, f2, f0, amp=0.35))
            elif c in _LIQUIDS:
                f1, f2 = _LIQUIDS[c]
                chunks.append(self._tone(base, f1, f2, f0, amp=0.4))
            elif c in _FRICS:
                chunks.append(self._noise(base, _FRICS[c]))
            elif c in _STOPS:
                chunks.append(self._silence(base * 0.3))
                chunks.append(self._noise(base * 0.4, 3000.0, amp=0.35))
            elif c == " ":
                chunks.append(self._silence(base * 0.8))
            elif c in ".,!?":
                chunks.append(self._silence(base * 2.0))
                f0 = self.pitch * 1.12  # pitch reset at clause boundaries
            if c.isalpha():
                f0 = max(f0 - step, self.pitch * 0.85)
            i += 1
        if not chunks:
            chunks = [self._silence(0.1)]
        wave = np.concatenate(chunks)
        peak = np.max(np.abs(wave)) + 1e-6
        return self.sr, (0.9 * wave / peak).astype(np.float32)


def _envelope(n: int, attack: float = 0.15) -> np.ndarray:
    """Attack/decay ramp avoiding clicks at phoneme boundaries."""
    a = max(int(n * attack), 1)
    env = np.ones(n)
    env[:a] = np.linspace(0.0, 1.0, a)
    env[-a:] *= np.linspace(1.0, 0.0, a)
    return env


def default_tts_fn(seed: int = 2):
    """The renderer's default backend (mirrors the reference's fixed
    ChatTTS speaker seed, render.py:146-151)."""
    return FormantTTS(seed)
