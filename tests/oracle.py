"""NumPy oracle: faithful transcription of the reference per-frame math.

Implements the exact formulas of the reference hot path with the same
dtypes and rounding (cited per function), used as ground truth for the
device pipeline tests.  Deliberately slow and simple.
"""

import numpy as np

X_OFFSET = 4242


def oracle_rectify_i16(events, mapx_i16, mapy_i16):
    """reference cam_proj_calibration.py:277-281"""
    xr = mapx_i16[events["y"], events["x"]]
    yr = mapy_i16[events["y"], events["x"]]
    return xr, yr


def oracle_disparity(xcr_i16, ycr_i16, t, x_map, t_px_scale):
    """reference x_maps_disparity.py:9-32 (float64 normalize + rint)."""
    min_t = t.min()
    max_t = t.max()
    event_norm_t = (t - min_t) / (max_t - min_t)
    t_scaled = np.rint(event_norm_t * t_px_scale).astype(np.int16)
    y_inlier_mask = (ycr_i16 >= 0) & (ycr_i16 < x_map.shape[0] - 1)
    x_proj = x_map[ycr_i16[y_inlier_mask], t_scaled[y_inlier_mask]]
    disp = x_proj.astype(np.int64) - xcr_i16[y_inlier_mask] - X_OFFSET
    disp_inlier_mask = disp >= 0
    full_mask = y_inlier_mask.copy()
    full_mask[y_inlier_mask] = disp_inlier_mask
    return disp[disp_inlier_mask].astype(np.float32), full_mask, t_scaled


def oracle_disp_map_projector_view(xr_i16, yr_i16, inlier_mask, disp_f32, H, W):
    """reference cam_proj_calibration.py:299-303"""
    xpr = np.rint(xr_i16[inlier_mask] + disp_f32).astype(np.int16)
    disp_map = np.zeros((H, W), dtype=np.float32)
    disp_map[yr_i16[inlier_mask], xpr] = disp_f32
    return disp_map


def oracle_disp_map_camera_view(events, inlier_mask, disp_f32, H, W):
    """reference cam_proj_calibration.py:312-317"""
    disp_map = np.zeros((H, W), dtype=np.float32)
    disp_map[events["y"][inlier_mask], events["x"][inlier_mask]] = disp_f32
    return disp_map


def oracle_dilate7(img):
    """reference disp_to_depth.py:86 (cv2.dilate 7x7, replicate border)."""
    pad = np.pad(img, 3, mode="edge")
    return np.max(
        np.lib.stride_tricks.sliding_window_view(pad, (7, 7)), axis=(2, 3)
    )


def oracle_remap_i16(img, mapx_i16, mapy_i16):
    """reference disp_to_depth.py:89-96 (INTER_NEAREST, BORDER_CONSTANT)."""
    H, W = img.shape
    xi = mapx_i16.astype(np.int64)
    yi = mapy_i16.astype(np.int64)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    return np.where(inb, out, 0).astype(img.dtype)


def oracle_disp_to_depth(disp, p03):
    """reference disp_to_depth.py:46-63"""
    depth = np.zeros_like(disp, dtype=np.float32)
    nz = disp != 0
    depth[nz] = np.maximum(np.float32(p03) / disp[nz], 1e-9)
    return depth


def oracle_clip_normalize_u8(depth, z_near, z_far):
    """reference disp_to_depth.py:7-21 (note np.uint8() truncation)."""
    z_near = np.float32(z_near)
    z_far = np.float32(z_far)
    rng = z_far - z_near
    out = np.zeros(depth.shape, dtype=np.uint8)
    nz = depth != 0
    val = np.clip(depth[nz], z_near, z_far)
    val = (val - z_near) / rng * 255
    out[nz] = val.astype(np.uint8)
    return out


def oracle_colorize(norm_u8, turbo_bgr):
    """reference disp_to_depth.py:34-43"""
    frame = turbo_bgr[norm_u8]
    frame[norm_u8 == 0] = 255
    return frame


def oracle_frame_projector_view(
    events, maps, x_map, t_px_scale, z_near, z_far, H_proj, W_proj
):
    """Full reference per-frame path, projector view
    (depth_reprojection_pipe.py:121-167)."""
    from xmaps.utils.colormap import TURBO_BGR_U8

    xr, yr = oracle_rectify_i16(events, maps.disp_cam_mapx_i16, maps.disp_cam_mapy_i16)
    disp, inlier, _ = oracle_disparity(xr, yr, events["t"], x_map, t_px_scale)
    H_rect, W_rect = maps.disp_cam_mapx_f32.shape[0], None
    H_rect = maps.calib.rect_image_height
    W_rect = maps.calib.rect_image_width
    disp_map = oracle_disp_map_projector_view(xr, yr, inlier, disp, H_rect, W_rect)
    dil = oracle_dilate7(disp_map)
    disp_proj = oracle_remap_i16(dil, maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16)
    depth = oracle_disp_to_depth(disp_proj, maps.P2[0, 3])
    u8 = oracle_clip_normalize_u8(depth, z_near, z_far)
    bgr = oracle_colorize(u8, np.asarray(TURBO_BGR_U8))
    return {
        "disp": disp,
        "inlier": inlier,
        "disp_map": disp_map,
        "disp_proj": disp_proj,
        "depth": depth,
        "u8": u8,
        "bgr": bgr,
    }
