"""X-map construction: time map (y, x -> t) to X-map (y, t -> x).

The reference builds this with a Numba triple loop over
(H_rect x W_time x W_rect) -- its slowest init step (x_map.py:5-55,
SURVEY.md §3.4).  Here it is a dense, embarrassingly parallel argmin that
XLA tiles onto the VPU: for each rectified row y and each time bin t, find
the x whose time-map entry is nearest to t, rejecting matches farther than
two scanline periods (2 / num_scanlines) and marking undefined entries with
0 (defined entries are offset by X_OFFSET, reference x_map.py:14,52).

Semantics preserved exactly:
- time bin t_coord==0 is skipped (undefined, x_map.py:34);
- time-map entries ==0 are skipped (x_map.py:42);
- first x wins ties (strict < comparison, x_map.py:46; jnp.argmin also
  returns the first minimum).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from xmaps.config import X_OFFSET

__all__ = ["build_x_map", "build_x_map_numpy"]


@functools.partial(
    jax.jit, static_argnames=("x_map_width", "t_px_scale", "num_scanlines", "row_block")
)
def build_x_map(
    time_map: jax.Array,
    *,
    x_map_width: int,
    t_px_scale: int,
    num_scanlines: int,
    row_block: int = 8,
) -> tuple[jax.Array, jax.Array]:
    """Build the X-map on device.

    Args:
        time_map: (H_rect, W_rect) float32 rectified projector time map.
        x_map_width: number of time bins (reference: projector width).
        t_px_scale: time scale (x_map_width - 1).
        num_scanlines: scanline count for the rejection threshold.
        row_block: rows processed per scan step (bounds peak memory at
            row_block * x_map_width * W_rect floats).

    Returns:
        (x_map, t_diffs): (H_rect, x_map_width) int16 X-map (values offset
        by X_OFFSET, 0 = undefined) and float32 min time differences.
    """
    H, W = time_map.shape
    max_t_diff = 2.0 / num_scanlines
    t_vals = (
        jnp.arange(x_map_width, dtype=jnp.float32) / jnp.float32(t_px_scale)
    )  # (T,)

    tm = jnp.where(time_map == 0.0, jnp.inf, time_map).astype(jnp.float32)

    def row_chunk(tm_rows):
        # tm_rows: (B, W); diffs: (B, T, W)
        diffs = jnp.abs(t_vals[None, :, None] - tm_rows[:, None, :])
        best_x = jnp.argmin(diffs, axis=-1).astype(jnp.int32)  # (B, T)
        best_d = jnp.min(diffs, axis=-1)  # (B, T)
        ok = (
            jnp.isfinite(best_d)
            & (best_d <= max_t_diff)
            & (t_vals[None, :] != 0.0)
        )
        xm = jnp.where(ok, best_x + X_OFFSET, 0).astype(jnp.int16)
        td = jnp.where(ok, best_d, 0.0).astype(jnp.float32)
        return xm, td

    pad = (-H) % row_block
    tm_pad = jnp.pad(tm, ((0, pad), (0, 0)), constant_values=jnp.inf)
    tm_blocks = tm_pad.reshape(-1, row_block, W)
    xm_blocks, td_blocks = jax.lax.map(row_chunk, tm_blocks)
    x_map = xm_blocks.reshape(-1, x_map_width)[:H]
    t_diffs = td_blocks.reshape(-1, x_map_width)[:H]
    return x_map, t_diffs


def build_x_map_numpy(
    time_map: np.ndarray,
    *,
    x_map_width: int,
    t_px_scale: int,
    num_scanlines: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized NumPy build (host fallback / test oracle).

    Direct transcription of the reference semantics (x_map.py:26-55).
    """
    H, W = time_map.shape
    max_t_diff = 2.0 / num_scanlines
    t_vals = np.arange(x_map_width, dtype=np.float64) / t_px_scale
    x_map = np.zeros((H, x_map_width), dtype=np.int16)
    t_diffs = np.zeros((H, x_map_width), dtype=np.float32)
    tm = np.where(time_map == 0.0, np.inf, time_map.astype(np.float64))
    for y in range(H):
        diffs = np.abs(t_vals[:, None] - tm[y][None, :])  # (T, W)
        best_x = np.argmin(diffs, axis=-1)
        best_d = diffs[np.arange(x_map_width), best_x]
        ok = np.isfinite(best_d) & (best_d <= max_t_diff) & (t_vals != 0.0)
        x_map[y] = np.where(ok, best_x + X_OFFSET, 0).astype(np.int16)
        t_diffs[y] = np.where(ok, best_d, 0.0).astype(np.float32)
    return x_map, t_diffs
