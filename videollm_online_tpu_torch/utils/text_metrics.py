"""Edit-distance utilities for fuzzy matching and AUED metrics.

The reference relies on the `Levenshtein` and `editdistance` C extensions
(data/coin/benchmarks.py:1, data/ego4d/lta.py:1). Here the hot path is the
native C++ kernel in native/textops (loaded via ctypes); a pure-Python
fallback keeps everything working without the compiled library.

A copy of ``videollm_online_tpu/utils/text_metrics.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

_LIB = None
_LIB_TRIED = False


def _native_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    for cand in (os.environ.get("VLO_TEXTOPS_LIB", ""),
                 os.path.join(here, "native", "build", "libtextops.so")):
        if cand and os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.levenshtein_bytes.restype = ctypes.c_int
            lib.levenshtein_bytes.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.levenshtein_u32.restype = ctypes.c_int
            lib.levenshtein_u32.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int]
            lib.levenshtein_best_match.restype = ctypes.c_int
            lib.levenshtein_best_match.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            _LIB = lib
            return _LIB
    return None


def _levenshtein_py(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def levenshtein(a: str, b: str) -> int:
    lib = _native_lib()
    if lib is not None:
        ab, bb = a.encode(), b.encode()
        return lib.levenshtein_bytes(ab, len(ab), bb, len(bb))
    return _levenshtein_py(a, b)


def edit_distance_ids(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein over integer sequences (editdistance.eval equivalent)."""
    lib = _native_lib()
    if lib is not None:
        a32 = np.ascontiguousarray(a, np.uint32)
        b32 = np.ascontiguousarray(b, np.uint32)
        return lib.levenshtein_u32(
            a32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(a32),
            b32.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(b32))
    return _levenshtein_py(list(a), list(b))


def fuzzy_match(text: str, choices: Sequence[str]) -> str:
    """Closest choice by edit distance, ties broken lexicographically —
    matches ``min([(dist, choice) ...])`` (data/coin/benchmarks.py:12-14)."""
    lib = _native_lib()
    if lib is not None and len(choices) > 8:
        encoded = [c.encode() for c in choices]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        lens = (ctypes.c_int * len(encoded))(*[len(c) for c in encoded])
        tb = text.encode()
        # native kernel returns the argmin by (distance, lexicographic)
        idx = lib.levenshtein_best_match(tb, len(tb), arr, lens, len(encoded))
        return choices[idx]
    return min((levenshtein(text, c), c) for c in choices)[1]
