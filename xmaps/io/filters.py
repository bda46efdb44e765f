"""Host-side per-packet stream filters: polarity + activity noise.

Replaces the reference's Metavision PolarityFilterAlgorithm and
ActivityNoiseFilterAlgorithm (depth_reprojection_pipe.py:43,65-67,114-117)
with the native C++ implementation in csrc/evt_decoder.cpp (ctypes), with a
NumPy fallback.  The time window is one projector frame period, as in the
reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from xmaps.io.evt_decoder import EVENT_DTYPE, _load_native


def polarity_filter(evs: np.ndarray, polarity: int = 1) -> np.ndarray:
    """Keep only events of one polarity (reference pos_filter)."""
    return evs[evs["p"] == polarity]


class ActivityNoiseFilter:
    """Removes isolated events with no recent 3x3 neighbor.

    Native C++ when available (stateful across packets); the NumPy
    fallback implements the *same sequential semantics exactly* (including
    within-packet unlocks) by replacing the sequential last-timestamp map
    walk with a binary search per neighbor offset: in (pixel, index)
    lexicographic order, the latest same-packet predecessor at a neighbor
    pixel is the entry just below (neighbor_pixel, i).  Events must be
    time-ordered (native contract), so that predecessor carries the
    pixel's max timestamp.  tests/test_filters.py asserts bit-equality of
    the two paths on correlated random streams.
    """

    def __init__(self, width: int, height: int, window_us: int,
                 keep_polarity: int = 1, force_numpy: bool = False):
        self.width = width
        self.height = height
        self.window_us = int(window_us)
        self.keep_polarity = keep_polarity
        self._lib = None if force_numpy else _load_native()
        self._handle: Optional[ctypes.c_void_p] = None
        if self._lib is not None and hasattr(self._lib, "act_filter_create"):
            self._lib.act_filter_create.restype = ctypes.c_void_p
            self._lib.act_filter_create.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ]
            self._lib.act_filter_apply.restype = ctypes.c_int64
            self._lib.act_filter_apply.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
            ]
            self._lib.act_filter_destroy.argtypes = [ctypes.c_void_p]
            self._lib.act_filter_reset.argtypes = [ctypes.c_void_p]
            self._handle = ctypes.c_void_p(
                self._lib.act_filter_create(width, height, self.window_us)
            )
        else:
            self._last_ts = np.full(
                (height + 2, width + 2), np.iinfo(np.int64).min // 2, np.int64
            )

    def __del__(self):
        if self._handle is not None and self._lib is not None:
            self._lib.act_filter_destroy(self._handle)
            self._handle = None

    def reset(self):
        if self._handle is not None:
            self._lib.act_filter_reset(self._handle)
        else:
            self._last_ts.fill(np.iinfo(np.int64).min // 2)

    def process(self, evs: np.ndarray) -> np.ndarray:
        if len(evs) == 0:
            return evs
        if self._handle is not None:
            xs = np.ascontiguousarray(evs["x"], np.uint16)
            ys = np.ascontiguousarray(evs["y"], np.uint16)
            ps = np.ascontiguousarray(evs["p"], np.int16)
            ts = np.ascontiguousarray(evs["t"], np.int64)
            m = self._lib.act_filter_apply(
                self._handle, len(evs), xs, ys, ps, ts, self.keep_polarity
            )
            out = np.zeros(m, dtype=EVENT_DTYPE)
            out["x"], out["y"], out["p"], out["t"] = xs[:m], ys[:m], ps[:m], ts[:m]
            return out

        # NumPy fallback: exact sequential semantics, vectorized.
        if self.keep_polarity >= 0:
            evs = evs[evs["p"] == self.keep_polarity]
        n = len(evs)
        if n == 0:
            return evs
        x = evs["x"].astype(np.int64) + 1
        y = evs["y"].astype(np.int64) + 1
        t = np.ascontiguousarray(evs["t"], np.int64)
        stride = self.width + 2
        pix = y * stride + x
        none = np.iinfo(np.int64).min // 2

        # neighbor timestamps carried over from previous packets
        best = np.full(n, none, np.int64)
        flat = self._last_ts.ravel()
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                np.maximum(best, flat[pix + dy * stride + dx], out=best)

        # within-packet unlocks: for event i and neighbor pixel q, the
        # latest predecessor j < i at q is the entry just below key
        # (q, i) in (pixel, index) order; time-ordered input makes that
        # entry the pixel's running max timestamp.
        key = pix * n + np.arange(n)  # unique: (pixel, index) in one i64
        sorter = np.argsort(key)
        skey = key[sorter]
        idx = np.arange(n)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                qpix = pix + dy * stride + dx
                pos = np.searchsorted(skey, qpix * n + idx) - 1
                safe = np.maximum(pos, 0)
                hit = (pos >= 0) & (skey[safe] // n == qpix)
                np.maximum(
                    best, np.where(hit, t[sorter[safe]], none), out=best
                )

        keep = (t - best) <= self.window_us
        # update state with all polarity-kept events; duplicate pixels
        # resolve to the last occurrence (the max timestamp, as native)
        self._last_ts[y, x] = t
        return evs[keep]
