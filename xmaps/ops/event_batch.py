"""Fixed-capacity SoA event batches (the device-side event representation).

The reference streams variable-length structured arrays
``{x:u16, y:u16, p:i16, t:i64}`` (Metavision EventCD).  XLA requires static
shapes, so frames are carried as fixed-capacity padded batches with a
validity count; every downstream op masks by validity.  Timestamps are
stored as int32 microseconds relative to the batch's ``t_base`` (a frame
spans ~16.7 ms, so 32 bits are ample) -- this keeps the hot path in
32-bit arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class EventBatch(NamedTuple):
    """One padded frame (or packet) of events, SoA layout.

    Attributes:
        x, y: pixel coordinates, int32, shape (capacity,).
        t: microseconds relative to ``t_base``, int32, shape (capacity,).
           For the offline ESL eval path, t may instead be float32 in [0, 1]
           (normalized time surface intensities, see
           reference eval/compute_depth_x_maps.py:82-96).
        p: polarity 0/1, int32, shape (capacity,).
        valid: bool mask, shape (capacity,).
        count: number of valid events, int32 scalar.
    """

    x: jax.Array
    y: jax.Array
    t: jax.Array
    p: jax.Array
    valid: jax.Array
    count: jax.Array

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def from_arrays(
        x: np.ndarray,
        y: np.ndarray,
        t: np.ndarray,
        p: np.ndarray,
        capacity: int,
        t_dtype=jnp.int32,
    ) -> "EventBatch":
        """Pad/truncate host arrays into a fixed-capacity batch.

        Absolute int64 timestamps are rebased to t[0] before narrowing to
        int32.
        """
        n = min(len(x), capacity)
        if len(x) > capacity:
            x, y, t, p = x[:capacity], y[:capacity], t[:capacity], p[:capacity]

        def pad(a, dtype):
            out = np.zeros(capacity, dtype=dtype)
            out[:n] = a[:n]
            return out

        if np.issubdtype(np.asarray(t).dtype, np.integer):
            t_rel = np.asarray(t, dtype=np.int64)
            if n:
                t_rel = t_rel - t_rel[0]
            t_arr = pad(t_rel, np.int32 if t_dtype == jnp.int32 else np.float32)
        else:
            t_arr = pad(np.asarray(t, dtype=np.float32), np.float32)

        valid = np.zeros(capacity, dtype=bool)
        valid[:n] = True
        return EventBatch(
            x=jnp.asarray(pad(x, np.int32)),
            y=jnp.asarray(pad(y, np.int32)),
            t=jnp.asarray(t_arr),
            p=jnp.asarray(pad(p, np.int32)),
            valid=jnp.asarray(valid),
            count=jnp.asarray(n, dtype=jnp.int32),
        )

    @staticmethod
    def from_structured(evs: np.ndarray, capacity: int) -> "EventBatch":
        """Build from a Metavision-style structured array with x/y/t/p."""
        return EventBatch.from_arrays(
            evs["x"], evs["y"], evs["t"], evs["p"], capacity
        )

    @staticmethod
    def from_structured_sorted(
        evs: np.ndarray, capacity: int, key: np.ndarray | None = None
    ) -> tuple["EventBatch", jax.Array]:
        """Build a batch stably sorted by raw y (or ``key``), plus the
        carried priorities.

        Returns (batch, priority) where priority[i] is the event's
        original arrival index -- pass both to the frame program
        (depth_frame(presort_priority=...)) for results bit-identical to
        arrival-order staging.  ``key`` (per-event, same length as evs)
        overrides the sort key: the engine passes the exact scatter
        target (XMapsDepthEngine.make_sorted_batch), which lets the
        device scatter run sort-free.

        Timestamps must be rebased BEFORE sorting (the device path rebases
        to the arrival-first event), so this mirrors from_arrays' rebase
        on the unsorted stream.
        """
        n = min(len(evs), capacity)
        evs = evs[:n]
        t_rel = np.asarray(evs["t"], dtype=np.int64)
        if n:
            t_rel = t_rel - t_rel[0]
        order = np.argsort(
            evs["y"][:n] if key is None else np.asarray(key)[:n],
            kind="stable",
        )
        batch = EventBatch.from_arrays(
            np.asarray(evs["x"])[order],
            np.asarray(evs["y"])[order],
            t_rel[order],
            np.asarray(evs["p"])[order],
            capacity,
        )
        # from_arrays rebases t to the first lane again; the sorted stream's
        # first lane is not the arrival-first event, so restore the correct
        # relative times explicitly.
        t_pad = np.zeros(capacity, np.int32)
        t_pad[:n] = t_rel[order]
        prio = np.zeros(capacity, np.int32)
        prio[:n] = order
        return (
            batch._replace(t=jnp.asarray(t_pad)),
            jnp.asarray(prio),
        )
