"""Dense per-frame image tail: dilate -> remap -> depth -> colorize.

Rebuilds the reference's per-frame OpenCV/Numba image stage
(disp_to_depth.py) as XLA ops that fuse into the single compiled frame
program:

- 7x7 max dilation of the sparse projector-view disparity map
  (cv2.dilate, disp_to_depth.py:74,86); for max-dilation, replicate border
  and -inf border are equivalent, so a plain reduce_window suffices;
- nearest remap rectified -> projector through the int16 inverse LUT
  (cv2.remap INTER_NEAREST/BORDER_CONSTANT, disp_to_depth.py:89-96);
- depth = P[0,3] / disp with zero-preserve (disp_to_depth.py:46-63),
  u8 clip/normalisation with C-style truncation (disp_to_depth.py:7-21)
  and the TURBO colormap with white where undefined (disp_to_depth.py:
  24-43, so reprojected light retriggers events).

Every disparity the pipeline produces is an integer in [0, PACK) (the
scatter packs it into PACK's field), so depth, u8 and colour are tables
over that range, computed once on the host in NumPy with the reference's
float32 arithmetic (``disparity_luts``) and looked up on the device.  The
frame is then bit-equal to the reference on any device, whatever the
device's division rounds to.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from xmaps.utils.colormap import TURBO_BGR_U8

__all__ = [
    "tail_crop_window",
    "dilate_max",
    "remap_nearest_i16",
    "DisparityLuts",
    "disparity_luts",
    "depth_and_frame",
    "turbo_packed_lut",
    "unpack_bgr",
]


def tail_crop_window(
    proj_mapx_i16: np.ndarray,
    proj_mapy_i16: np.ndarray,
    rect_height: int,
    rect_width: int,
    halo: int = 3,
) -> tuple[int, int, int, int]:
    """(row0, col0, H, W): the window of the rectified frame that the
    projector-view tail can see.

    The remap samples only the rect pixels its maps point at; the 7x7
    dilation widens that by ``halo`` pixels.  A scatter target outside the
    window is more than ``halo`` pixels from every sampled source, so
    scattering into the window alone, dilating it with an empty border
    and remapping with window-relative maps (``remap_nearest_i16``'s
    ``origin``) is bit-identical to the full-frame chain.  At the ESL
    evaluation rig the window is a few percent of the 5760x3240 frame.
    A host function of the static projector maps, computed once per
    calibration.
    """
    X = np.asarray(proj_mapx_i16, np.int64)
    Y = np.asarray(proj_mapy_i16, np.int64)
    inb = (X >= 0) & (X < rect_width) & (Y >= 0) & (Y < rect_height)
    if not inb.any():
        return 0, 0, rect_height, rect_width
    r_lo = max(int(Y[inb].min()) - halo, 0)
    r_hi = min(int(Y[inb].max()) + halo, rect_height - 1)
    c_lo = max(int(X[inb].min()) - halo, 0)
    c_hi = min(int(X[inb].max()) + halo, rect_width - 1)
    return r_lo, c_lo, r_hi - r_lo + 1, c_hi - c_lo + 1


def dilate_max(img: jax.Array, ksize: int = 7) -> jax.Array:
    """Grayscale max-dilation with a ksize x ksize square structuring
    element, SAME padding (equivalent to cv2.dilate with BORDER_REPLICATE
    for max filters)."""
    return jax.lax.reduce_window(
        img,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(ksize, ksize),
        window_strides=(1, 1),
        padding="SAME",
    )


def remap_nearest_i16(
    img: jax.Array,
    mapx_i16: jax.Array,
    mapy_i16: jax.Array,
    origin: tuple[int, int] = (0, 0),
) -> jax.Array:
    """Nearest remap through integer LUTs, BORDER_CONSTANT(0) semantics.

    ``out[i, j] = img[mapy[i, j] - row0, mapx[i, j] - col0]`` where in
    bounds, else 0.  ``origin`` = (row0, col0) places ``img`` as a window
    of the frame the maps address (``tail_crop_window``); a source outside
    the frame stays outside the window.
    """
    H, W = img.shape
    xi = mapx_i16.astype(jnp.int32) - origin[1]
    yi = mapy_i16.astype(jnp.int32) - origin[0]
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xc = jnp.clip(xi, 0, W - 1)
    yc = jnp.clip(yi, 0, H - 1)
    vals = img[yc, xc]
    return jnp.where(inb, vals, jnp.zeros((), dtype=img.dtype))


class DisparityLuts(NamedTuple):
    """Per-disparity tables, indexed by the integer disparity in [0, PACK)."""

    depth: np.ndarray  # (PACK,) float32 metric depth, 0 = undefined
    u8: np.ndarray  # (PACK,) uint8 normalised depth, 0 = undefined
    bgr: np.ndarray  # (PACK,) uint32 packed TURBO colour (B | G<<8 | R<<16)


@functools.lru_cache(maxsize=16)
def disparity_luts(p03: float, z_near: float, z_far: float) -> DisparityLuts:
    """Depth, u8 and colour for every integer disparity, in NumPy float32.

    depth = max(P[0,3] / disp, 1e-9) with 0 kept for disp == 0 (the
    simplified rectified-depth formula of disp_to_depth.py:46-63, which
    neglects the rectification rotation); u8 = clip to [z_near, z_far],
    scale to [0, 255], C-truncate, 0 kept for undefined
    (disp_to_depth.py:7-21); colour = TURBO with white at u8 == 0
    (disp_to_depth.py:24-43).
    """
    from xmaps.ops.scatter import PACK

    disp = np.arange(PACK, dtype=np.float32)
    nz = disp != 0
    depth = np.zeros(PACK, np.float32)
    depth[nz] = np.maximum(np.float32(p03) / disp[nz], np.float32(1e-9))
    zn, zf = np.float32(z_near), np.float32(z_far)
    val = (np.clip(depth[nz], zn, zf) - zn) / (zf - zn) * np.float32(255)
    u8 = np.zeros(PACK, np.uint8)
    u8[nz] = np.clip(val, 0, 255).astype(np.uint8)  # C truncation
    return DisparityLuts(depth, u8, turbo_packed_lut()[u8])


def depth_and_frame(
    disp: jax.Array, luts: DisparityLuts, packed: bool = False
) -> tuple[jax.Array, jax.Array]:
    """(depth f32, colorized frame) of an integer-valued disparity map:
    the frame as one u32 packed-BGR plane when ``packed``, else
    (H, W, 3) u8 BGR."""
    d = disp.astype(jnp.int32)
    bgr = jnp.asarray(luts.bgr)[d]
    return (
        jnp.asarray(luts.depth)[d],
        bgr if packed else unpack_bgr(bgr),
    )


def turbo_packed_lut() -> np.ndarray:
    """(256,) u32 packed-BGR TURBO LUT (B | G<<8 | R<<16) with entry 0
    white: the reference paints undefined pixels (u8 == 0) white, so one
    lookup yields all three channels."""
    v = TURBO_BGR_U8.astype(np.uint32)
    packed = v[:, 0] | (v[:, 1] << 8) | (v[:, 2] << 16)
    packed[0] = 0xFFFFFF  # undefined pixels render white
    return packed


def unpack_bgr(packed: jax.Array) -> jax.Array:
    """(H, W) u32 packed BGR -> (H, W, 3) u8 planes."""
    return jnp.stack(
        [(packed >> s) & 255 for s in (0, 8, 16)], axis=-1
    ).astype(jnp.uint8)
