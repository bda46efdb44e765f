"""Deterministic disparity-map scatter (device).

The reference scatters per-event disparities into a dense map with NumPy
fancy indexing, whose semantics are "last write in index order wins"
(cam_proj_calibration.py:299-317).  A plain XLA scatter with duplicate
indices has unspecified winner order, so we make the reduction associative:
each event's integer-valued disparity is packed with its batch index as

    packed = (event_index + 1) * PACK + disp        (uint32)

and scattered with max.  The highest event index wins -- exactly NumPy's
last-write-wins -- and unpacking recovers the disparity.  This keeps the
op deterministic, reproducible across shardings (see parallel/), and
bit-identical to the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["scatter_disp_last_wins", "scatter_disp_packed", "unpack_disp", "PACK"]

#: Disparity field width.  Must exceed any valid disparity (bounded by the
#: rectified image width, <= ~5800 for the ESL configuration).  uint32
#: packing supports priorities up to 2**32 / PACK - 2 = 524286 -- enough
#: for the offline eval's whole-image batches (640*480 = 307200) with
#: headroom.  All priorities are event indices or dense ranks < capacity
#: (ops.filters rank-compresses its raster keys), so one field width
#: serves every path.
PACK = 8192


def scatter_disp_packed(
    ys: jax.Array,
    xs: jax.Array,
    disp: jax.Array,
    inlier: jax.Array,
    *,
    height: int,
    width: int,
    index_offset: jax.Array | int = 0,
    priority: jax.Array | None = None,
    pad_shape: tuple[int, int] | None = None,
    method: str = "max",
    window: tuple[int, int, int, int] | None = None,
    run_keys: tuple[jax.Array, jax.Array] | None = None,
) -> jax.Array:
    """Scatter index-packed disparities; returns the packed uint32 map.

    The last-write-wins priority is the event index by default (NumPy
    fancy-indexing order); ``index_offset`` shifts it so event shards on
    different devices keep globally consistent ordering (partial packed
    maps then combine exactly with an elementwise max -- see
    parallel.sharding).  ``priority`` overrides it with another
    order-equivalent permutation: the arrival indices of a host-sorted
    batch, or the dedup filters' dense raster ranks (ops.filters).  All
    priorities must be < capacity.  ``pad_shape`` scatters into a larger
    zero-padded map (rows/cols beyond height/width stay 0).  ``window`` =
    (oy, ox, wh, ww) scatters into that window of the frame only
    (targets outside it are dropped; ops.image_tail.tail_crop_window).

    ``method`` selects the strategy (identical results):

    - "max": one scatter-max of the packed values (on a GPU an atomic
      max per lane, order-independent because the priority is packed in).
    - "sorted": sort by (pixel, packed), keep only each pixel's winner
      (the max-packed lane = the max-priority event), then a
      unique-indices scatter-set.  Correct for any lane order.
    - "set": the caller guarantees every kept lane targets a DISTINCT
      pixel and is that pixel's winner (host-compacted winner batches,
      models.depth_pipeline.make_winner_batch): one bare unique-indices
      scatter-set over the batch, nothing else.
    - "runs": like "sorted" but WITHOUT the device sort: the caller
      guarantees that lanes targeting the same pixel are already
      CONTIGUOUS (the host sorted the batch by the scatter
      target, which it can mirror exactly -- models.depth_pipeline
      .make_sorted_batch).  ``run_keys`` = (ky, kx) i32 arrays defined
      for EVERY lane (winners and rejects alike; e.g. the clipped
      rectified row + raw X-map value) with: equal (ky, kx) <=> same
      target pixel, and equal keys contiguous among real lanes.  The
      host additionally sorts, WITHIN each run, all lanes this scatter
      will reject (the exact ``ok`` mask below, which the host mirrors
      bit-for-bit) before all lanes it will keep, keeps kept lanes in
      ascending ``priority`` order, and never assigns a real lane's key
      to a trailing padding lane except contiguously -- so each run's
      winner is simply its LAST kept lane, found with one neighbor
      compare: a lane wins iff packed > 0 and its successor starts a
      new key or carries packed == 0 (a padding lane or the rejects
      prefix of nothing: kept lanes are a run's tail, so a same-key
      successor with packed == 0 can only be padding).  Winners then go
      through the same unique-indices scatter-set.  Non-adjacent
      padding key coincidences are harmless (the test is local); the
      final lane is forced to be a boundary so a single all-equal-key
      batch still crowns its last lane.
    """
    n = ys.shape[0]
    assert method in ("max", "sorted", "runs", "set"), method
    if window is not None:
        # Scatter into a CROP of the logical (height, width) frame: the
        # map covers rows [oy, oy+wh) x cols [ox, ox+ww); targets outside
        # are dropped (callers guarantee they are invisible -- e.g. the
        # tail's crop window, ops.image_tail.tail_crop_window).
        oy, ox, wh, ww = window
        assert 0 <= oy and oy + wh <= height and 0 <= ox and ox + ww <= width
    else:
        oy = ox = 0
        wh, ww = height, width
    out_h, out_w = pad_shape if pad_shape is not None else (wh, ww)
    assert out_h >= wh and out_w >= ww
    if isinstance(index_offset, int):
        assert (n + index_offset + 1) * PACK < 2**32, (
            f"event capacity {n} overflows the uint32 PACK packing"
        )
    disp_i = disp.astype(jnp.int32)
    ysc = ys - oy
    xsc = xs - ox
    ok = (
        inlier
        & (ysc >= 0)
        & (ysc < wh)
        & (xsc >= 0)
        & (xsc < ww)
        & (disp_i >= 0)
        & (disp_i < PACK)
    )
    if priority is None:
        priority = jnp.arange(n, dtype=jnp.int32) + index_offset
    packed = jnp.where(
        ok,
        (priority.astype(jnp.uint32) + 1) * jnp.uint32(PACK)
        + disp_i.astype(jnp.uint32),
        jnp.uint32(0),
    )
    # Out-of-bounds scatter indices are dropped; route masked lanes there.
    lin = jnp.where(ok, ysc * out_w + xsc, out_h * out_w)
    out = jnp.zeros((out_h, out_w), dtype=jnp.uint32)

    def _set(tgt, vals):
        r, c = tgt // out_w, tgt % out_w
        return out.at[r, c].set(vals, mode="drop", unique_indices=True)

    if method == "set":
        # Host-compacted winner batch (models.depth_pipeline
        # .make_winner_batch): every kept lane already targets a DISTINCT
        # pixel and IS that pixel's winner, so this is a bare
        # unique-indices set -- no device sort, no winner detection.
        # Masked lanes were routed out of bounds by ``lin`` above.
        return _set(lin, packed)
    if method == "runs":
        assert run_keys is not None, "method='runs' requires run_keys"
        ky, kx = run_keys
        # the host sorted each run as [rejects..., kept ascending-packed],
        # so the run's winner is its last kept lane: packed > 0 with a
        # key boundary or a padding (packed == 0) successor.  One
        # neighbor compare -- no scan, no sort.
        iota = jax.lax.iota(jnp.int32, n)
        boundary = (
            (ky != jnp.roll(ky, -1))
            | (kx != jnp.roll(kx, -1))
            | (iota == n - 1)  # roll wraps; the final lane always ends a run
        )
        win = (packed > jnp.uint32(0)) & (
            boundary | (jnp.roll(packed, -1) == jnp.uint32(0))
        )
        tgt = jnp.where(win, lin, out_h * out_w)
        return _set(tgt, packed)
    if method == "sorted":
        lin_s, packed_s = jax.lax.sort((lin, packed), num_keys=2)
        is_win = jnp.concatenate(
            [lin_s[:-1] != lin_s[1:], jnp.ones((1,), jnp.bool_)]
        ) & (lin_s < out_h * out_w)
        tgt = jnp.where(is_win, lin_s, out_h * out_w)
        # sentinel rows land at out_h (out of bounds) and are dropped
        return _set(tgt, packed_s)
    return out.at[lin // out_w, lin % out_w].max(packed, mode="drop")


def unpack_disp(packed: jax.Array, pack: int = PACK) -> jax.Array:
    """Recover the float32 disparity map from a packed map."""
    return (packed % jnp.uint32(pack)).astype(jnp.float32)


def scatter_disp_last_wins(
    ys: jax.Array,
    xs: jax.Array,
    disp: jax.Array,
    inlier: jax.Array,
    *,
    height: int,
    width: int,
) -> jax.Array:
    """Scatter integer-valued disparities; last valid event per pixel wins.

    Args:
        ys, xs: (N,) int32 target pixel coordinates.
        disp: (N,) float32 integer-valued disparities (>= 0 for inliers).
        inlier: (N,) bool; non-inliers are dropped.
        height, width: output map size.

    Returns:
        (height, width) float32 disparity map, 0 where no event landed.
    """
    return unpack_disp(
        scatter_disp_packed(
            ys, xs, disp, inlier, height=height, width=width
        )
    )
