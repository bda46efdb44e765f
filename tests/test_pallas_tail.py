"""The projector-view tail over its crop window vs the full-frame tail."""

import numpy as np
import pytest

import jax.numpy as jnp

from xmaps.calib.maps import CamProjMaps
from xmaps.ops.image_tail import (
    depth_and_frame,
    dilate_max,
    disparity_luts,
    remap_nearest_i16,
    tail_crop_window,
    turbo_packed_lut,
    unpack_bgr,
)
from xmaps.ops.scatter import PACK, unpack_disp
from xmaps.utils.synthetic import make_synthetic_calibration


@pytest.fixture(scope="module")
def rig():
    calib = make_synthetic_calibration()
    maps = CamProjMaps(calib)
    crop = tail_crop_window(
        maps.disp_proj_mapx_i16,
        maps.disp_proj_mapy_i16,
        calib.rect_image_height,
        calib.rect_image_width,
    )
    return calib, maps, crop


def _luts(maps):
    return disparity_luts(float(maps.P2[0, 3]), 0.2, 1.2)


def _xla_tail(disp_rect, maps):
    dil = dilate_max(disp_rect, 7)
    rm = remap_nearest_i16(
        dil, jnp.asarray(maps.disp_proj_mapx_i16), jnp.asarray(maps.disp_proj_mapy_i16)
    )
    return depth_and_frame(rm, _luts(maps))[1], rm


def _crop_tail(packed, maps, crop):
    """Unpack, dilate and remap the crop window only (the frame
    program's tail), then look depth and colour up."""
    r0, c0, h, w = crop
    dil = dilate_max(unpack_disp(jnp.asarray(packed[r0:r0 + h, c0:c0 + w])), 7)
    rm = remap_nearest_i16(
        dil, jnp.asarray(maps.disp_proj_mapx_i16),
        jnp.asarray(maps.disp_proj_mapy_i16), origin=(r0, c0),
    )
    return depth_and_frame(rm, _luts(maps), packed=True)[1], rm


def test_pallas_tail_matches_xla(rig, rng):
    calib, maps, crop = rig
    H, W = calib.rect_image_height, calib.rect_image_width
    # sparse packed disparity map like a scattered frame (priority bits
    # above the disparity field must be masked off by the kernel)
    packed = np.zeros((H, W), np.uint32)
    n = 2000
    ys = rng.integers(0, H, n)
    xs = rng.integers(0, W, n)
    disp = rng.integers(1, 160, n)
    packed[ys, xs] = (rng.integers(1, 1000, n) * PACK + disp).astype(np.uint32)
    dense = (packed % PACK).astype(np.float32)

    bgr, disp_p = _crop_tail(packed, maps, crop)
    frame_x, disp_x = _xla_tail(jnp.asarray(dense), maps)
    assert (np.asarray(disp_x) > 0).mean() > 0.05

    np.testing.assert_array_equal(np.asarray(disp_p), np.asarray(disp_x))
    np.testing.assert_array_equal(
        np.asarray(unpack_bgr(bgr)), np.asarray(frame_x)
    )


def test_pallas_tail_empty(rig):
    calib, maps, crop = rig
    H, W = calib.rect_image_height, calib.rect_image_width
    bgr, disp_p = _crop_tail(np.zeros((H, W), np.uint32), maps, crop)
    assert (np.asarray(disp_p) == 0).all()
    assert (np.asarray(unpack_bgr(bgr)) == 255).all()  # all undefined -> white


def test_tail_crop_window_demo_rig():
    """At the demonstrator rig the tail sees 901x532 of the 1320x1760
    rect frame; a map that samples nothing keeps the full frame."""
    calib = make_synthetic_calibration(
        camera_width=640, camera_height=480,
        projector_width=720, projector_height=1280,
    )
    maps = CamProjMaps(calib)
    crop = tail_crop_window(
        maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16,
        calib.rect_image_height, calib.rect_image_width,
    )
    assert crop == (95, 369, 901, 532)
    none = np.full((4, 4), -1, np.int16)
    assert tail_crop_window(none, none, 30, 40) == (0, 0, 30, 40)


def test_packed_lut_matches_turbo():
    """The packed-BGR LUT must reproduce TURBO exactly, with entry 0
    pre-whitened (the u8==0 white-mask fold)."""
    from xmaps.utils.colormap import TURBO_BGR_U8

    flat = turbo_packed_lut().astype(np.int64)
    assert flat.shape == (256,)
    b = flat & 255
    g = (flat >> 8) & 255
    r = flat >> 16
    exp = TURBO_BGR_U8.astype(np.int64).copy()
    exp[0] = 255  # white fold
    np.testing.assert_array_equal(b, exp[:, 0])
    np.testing.assert_array_equal(g, exp[:, 1])
    np.testing.assert_array_equal(r, exp[:, 2])
