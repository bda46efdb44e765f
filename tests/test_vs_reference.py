"""Differential tests against the ACTUAL reference implementation.

Everything else in tests/ compares xmaps to transcriptions
(tests/oracle.py); a transcription error would be invisible.  This module
imports the reference modules from /root/reference/python directly and
runs the reference's own per-frame code end to end -- rectify
(cam_proj_calibration.py:277-281) -> projector time map
(proj_time_map.py:6-44) -> X-map (x_map.py:6-55) -> disparity
(x_maps_disparity.py:9-32) -> scatter (cam_proj_calibration.py:299-317)
-> dilate/remap (disp_to_depth.py:76-97) -> depth/colorize
(disp_to_depth.py:47-141) -- on synthetic events, asserting bit-equality
(or pinning exact deltas) against xmaps at every stage.

numba is shimmed with a passthrough jit/prange: the decorated reference
functions are pure NumPy/Python and run unchanged (slowly, hence the
small synthetic rig).  cv2 is NOT shimmed -- the reference's
stereoRectify / initUndistortRectifyMap / dilate / remap / applyColorMap
run for real.
"""

from __future__ import annotations

import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REF = Path("/root/reference/python")
pytestmark = pytest.mark.skipif(
    not REF.exists(), reason="reference checkout not available"
)


def _install_numba_shim():
    """A passthrough numba for the reference's @numba.jit decorations.

    The decorated functions (x_map.py:5, disp_to_depth.py:7,24,46) are
    pure NumPy/Python; without numba installed they execute as-is.  If a
    real numba exists it is used instead (identical results, faster).
    """
    try:
        import numba  # noqa: F401  (real numba, if present)

        return
    except ImportError:
        pass
    if "numba" in sys.modules:
        return
    shim = types.ModuleType("numba")

    def jit(*args, **kwargs):
        if args and callable(args[0]) and not kwargs:
            return args[0]

        def deco(fn):
            return fn

        return deco

    shim.jit = jit
    shim.njit = jit
    shim.prange = range
    sys.modules["numba"] = shim


class _StatsShim:
    """Minimal stats object for DisparityToDepth (not under test)."""

    @contextlib.contextmanager
    def measure_time(self, name):
        yield

    def add_metric(self, name, value):
        pass


@pytest.fixture(scope="module")
def ref_modules():
    _install_numba_shim()
    sys.path.insert(0, str(REF))
    try:
        import cam_proj_calibration as ref_calib
        import disp_to_depth as ref_d2d
        import frame_event_filter as ref_fef
        import proj_time_map as ref_ptm
        import x_maps_disparity as ref_xmd

        yield types.SimpleNamespace(
            calib=ref_calib,
            ptm=ref_ptm,
            xmd=ref_xmd,
            d2d=ref_d2d,
            fef=ref_fef,
        )
    finally:
        sys.path.remove(str(REF))


@pytest.fixture(scope="module")
def rig(ref_modules):
    """One small synthetic rig built BOTH ways from the same parameters."""
    from xmaps.calib.maps import CamProjMaps
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration()  # 64x48 cam, 90x160 proj
    ref_params = ref_modules.calib.CamProjCalibrationParams(
        camera_width=calib.camera_width,
        camera_height=calib.camera_height,
        projector_width=calib.projector_width,
        projector_height=calib.projector_height,
        rect_image_width=calib.rect_image_width,
        rect_image_height=calib.rect_image_height,
        camera_K=calib.camera_K,
        camera_D=calib.camera_D,
        projector_K=calib.projector_K,
        projector_D=calib.projector_D,
        cam2proj_R=calib.cam2proj_R,
        cam2proj_T=calib.cam2proj_T,
    )
    ref_maps = ref_modules.calib.CamProjMaps(ref_params)
    my_maps = CamProjMaps(calib)

    rng = np.random.default_rng(42)
    evs = simulate_plane_events(
        calib, depth_m=0.55, subsample=0.9, jitter_us=3.0, rng=rng
    )
    # exercise the polarity drop in the reference filters
    evs["p"][::7] = 0
    cap = int(2 ** np.ceil(np.log2(len(evs) + 1)))
    return types.SimpleNamespace(
        calib=calib, ref_params=ref_params, ref_maps=ref_maps,
        my_maps=my_maps, evs=evs, cap=cap,
    )


@pytest.fixture(scope="module")
def engine(rig):
    from xmaps.models.depth_pipeline import XMapsDepthEngine

    return XMapsDepthEngine.from_calibration(
        rig.calib, event_capacity=rig.cap, z_near=0.2, z_far=1.2
    )


# ---------------------------------------------------------------------------
# Stage 1: rectification LUTs (cam_proj_calibration.py:174-270)
# ---------------------------------------------------------------------------


def test_rectification_luts_bit_equal(rig):
    # the reference packs the projector inverse map as one cv2 2-channel
    # CV_16SC2 array (cam_proj_calibration.py:51-53); xmaps keeps the
    # planes separate
    ref_xy = np.asarray(rig.ref_maps.disp_proj_mapxy_i16)
    np.testing.assert_array_equal(
        ref_xy[..., 0], np.asarray(rig.my_maps.disp_proj_mapx_i16)
    )
    np.testing.assert_array_equal(
        ref_xy[..., 1], np.asarray(rig.my_maps.disp_proj_mapy_i16)
    )
    for name in (
        "disp_cam_mapx_i16",
        "disp_cam_mapy_i16",
        "camera_mapx",
        "camera_mapy",
        "projector_mapx",
        "projector_mapy",
        "P1",
        "P2",
        "Q",
    ):
        ref_v = getattr(rig.ref_maps, name)
        my_v = getattr(rig.my_maps, name)
        np.testing.assert_array_equal(
            np.asarray(ref_v), np.asarray(my_v), err_msg=name
        )


# ---------------------------------------------------------------------------
# Stage 2: projector time map (proj_time_map.py:6-44)
# ---------------------------------------------------------------------------


def test_rectified_time_map_bit_equal(rig, ref_modules):
    ref_tm = ref_modules.ptm.ProjectorTimeMap.from_calib(
        rig.ref_params, rig.ref_maps
    ).projector_time_map_rectified
    my_tm = rig.my_maps.build_rectified_time_map()
    np.testing.assert_array_equal(ref_tm, my_tm)


# ---------------------------------------------------------------------------
# Stage 3: X-map (x_map.py:6-55 via x_maps_disparity.py:44-67)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_xmaps_disp(rig, ref_modules):
    tm = ref_modules.ptm.ProjectorTimeMap.from_calib(
        rig.ref_params, rig.ref_maps
    ).projector_time_map_rectified
    return ref_modules.xmd.XMapsDisparity(
        calib_params=rig.ref_params,
        cam_proj_maps=rig.ref_maps,
        proj_time_map_rect=tm,
    )


def test_x_map_bit_equal(rig, ref_xmaps_disp):
    """The host (f64) build matches the reference search exactly; the
    device (f32) build is pinned separately in tests/test_ops.py (argmin
    tie flips < 2e-3 of entries)."""
    from xmaps.config import X_OFFSET
    from xmaps.ops.xmap import build_x_map_numpy

    assert ref_xmaps_disp.X_OFFSET == X_OFFSET  # x_maps_disparity.py:50
    tm = rig.my_maps.build_rectified_time_map()
    my_xmap, _ = build_x_map_numpy(
        tm,
        x_map_width=rig.calib.projector_width,
        t_px_scale=rig.calib.projector_width - 1,
        num_scanlines=rig.calib.projector_width,
    )
    np.testing.assert_array_equal(ref_xmaps_disp.proj_x_map, my_xmap)


# ---------------------------------------------------------------------------
# Stage 4..8: the reference per-frame path (depth_reprojection_pipe.py:
# 121-167), run with the reference's own code
# ---------------------------------------------------------------------------


def _ref_frame(rig, ref_modules, ref_xmd, evs, *, camera_view=False,
               ref_filter=None, z_near=0.2, z_far=1.2):
    """The reference's process_ev_frame, verbatim semantics
    (depth_reprojection_pipe.py:121-167)."""
    d2d = ref_modules.d2d.DisparityToDepth(
        stats=_StatsShim(), calib_params=rig.ref_params,
        calib_maps=rig.ref_maps, z_near=z_near, z_far=z_far,
    )
    xr, yr = rig.ref_maps.rectify_cam_coords_i16(evs)
    if ref_filter is not None:
        filtered = ref_filter.filter_events(evs, xr)
        if len(filtered) < len(evs):
            xr, yr = rig.ref_maps.rectify_cam_coords_i16(filtered)
        evs = filtered
    disp, inlier_mask = ref_xmd.compute_event_disparity(evs, xr, yr)
    if camera_view:
        disp_map = rig.ref_maps.compute_disp_map_camera_view(
            events=evs, inlier_mask=inlier_mask, ev_disparity_f32=disp
        )
    else:
        disp_map = rig.ref_maps.compute_disp_map_projector_view(
            ev_x_rect_i16=xr, ev_y_rect_i16=yr,
            inlier_mask=inlier_mask, ev_disparity_f32=disp,
        )
        disp_map = d2d.remap_rectified_disp_map_to_proj(disp_map)
    frame = d2d.colorize_depth_from_disp(disp_map)
    return types.SimpleNamespace(
        frame_bgr=frame, disp_map=disp_map,
        num_inliers=int(inlier_mask.sum()),
    )


def test_frame_projector_view_bit_equal(rig, ref_modules, ref_xmaps_disp,
                                        engine):
    # the polarity filter runs upstream of the frame path on both sides
    # (depth_reprojection_pipe.py:110-118)
    pos = rig.evs[rig.evs["p"] == 1]
    ref = _ref_frame(rig, ref_modules, ref_xmaps_disp, pos)
    mine = engine.process_frame(pos)
    assert int(mine.num_inliers) == ref.num_inliers
    np.testing.assert_array_equal(ref.disp_map, np.asarray(mine.disp_map))
    np.testing.assert_array_equal(ref.frame_bgr, np.asarray(mine.frame_bgr))


def test_frame_camera_view_bit_equal(rig, ref_modules, ref_xmaps_disp):
    from xmaps.models.depth_pipeline import XMapsDepthEngine

    eng = XMapsDepthEngine.from_calibration(
        rig.calib, event_capacity=rig.cap, z_near=0.2, z_far=1.2,
        camera_perspective=True,
    )
    pos = rig.evs[rig.evs["p"] == 1]
    ref = _ref_frame(
        rig, ref_modules, ref_xmaps_disp, pos, camera_view=True
    )
    mine = eng.process_frame(pos)
    assert int(mine.num_inliers) == ref.num_inliers
    np.testing.assert_array_equal(ref.disp_map, np.asarray(mine.disp_map))
    np.testing.assert_array_equal(ref.frame_bgr, np.asarray(mine.frame_bgr))


def test_depth_surface_bit_equal(rig, ref_modules, ref_xmaps_disp, engine):
    """The metric depth map itself (disp_to_depth.py:47-63), not just its
    colorization."""
    pos = rig.evs[rig.evs["p"] == 1]
    ref = _ref_frame(rig, ref_modules, ref_xmaps_disp, pos)
    ref_depth = ref_modules.d2d.disparity_to_depth_rectified(
        ref.disp_map, rig.ref_maps.P2
    )
    mine = engine.process_frame(pos)
    np.testing.assert_array_equal(ref_depth, np.asarray(mine.depth))


# ---------------------------------------------------------------------------
# The 4 dedup filters (frame_event_filter.py:19-129), through the FULL
# frame path on both sides.
#
# The reference implements its per-pixel winner choice with duplicate-index
# fancy scatters (forward for "last", REVERSED for "first",
# frame_event_filter.py:27,52-53).  NumPy documents the duplicate winner
# as unspecified, and it really is: on NumPy 2.0.2 the reversed scatter
# keeps the FIRST event for small arrays but the LAST for realistic event
# counts (the vectorized mapiter path writes in memory order) -- so the
# reference's "first event" filters silently became "last event" under
# NumPy 2.  xmaps implements the documented intent (true first by
# stream order) deterministically (ops/filters.py).  Therefore:
#
# - full-path bit-equality is asserted on a WINNER-NEUTRAL event set
#   (every event of a dedup key carries the same timestamp, so any winner
#   yields identical output) -- this still exercises the key structure,
#   raster re-emission priorities, t re-normalization, and the mean
#   timestamp rewrite;
# - on the jittered set, the surviving PIXEL SET (well-defined regardless
#   of winner) is asserted equal, and full equality only for last_per_xy
#   (the one filter whose executed winner is stable in practice);
# - xmaps's own winner choice is pinned to the documented intent.
# ---------------------------------------------------------------------------

_FILTER_PAIRS = [
    ("last_per_xy", "LastEventPerXYFilter"),
    ("first_per_xy", "FirstEventPerXYFilter"),
    ("first_per_yt", "FirstEventPerYTFilter"),
    ("mean_first_last_per_xy", "MeanFirstLastEventPerXYFilter"),
]


@pytest.fixture(scope="module")
def neutral_evs(rig):
    """Events whose timestamp is a pure function of the dedup key, so
    every filter's winner choice is value-irrelevant.  first_per_yt keys
    on (raw y, rectified x) (frame_event_filter.py:70-99), which groups
    several camera pixels; keying t on (y, x_rect) makes it neutral for
    ALL four filters (the *_per_xy keys subdivide it)."""
    evs = rig.evs.copy()
    xr = np.asarray(rig.my_maps.disp_cam_mapx_i16)[evs["y"], evs["x"]]
    xr = np.clip(xr.astype(np.int64), 0, rig.calib.rect_image_width - 1)
    evs["t"] = (
        evs["y"].astype(np.int64) * rig.calib.rect_image_width + xr
    ) * 3 + 1000
    # keep stream order irrelevant but non-monotonic
    return evs


@pytest.mark.parametrize("my_name,ref_name", _FILTER_PAIRS)
def test_filtered_frame_bit_equal_winner_neutral(
    rig, ref_modules, ref_xmaps_disp, neutral_evs, my_name, ref_name
):
    from xmaps.models.depth_pipeline import XMapsDepthEngine

    # the pipe's polarity filter runs upstream of the dedup filters
    # (depth_reprojection_pipe.py:110-118): the reference filter requires
    # it (its xp_i16 argument must align with the already-p-filtered
    # events, frame_event_filter.py:72-79)
    pos = neutral_evs[neutral_evs["p"] == 1]
    ref_filter = getattr(ref_modules.fef, ref_name)()
    ref = _ref_frame(
        rig, ref_modules, ref_xmaps_disp, pos, ref_filter=ref_filter
    )
    eng = XMapsDepthEngine.from_calibration(
        rig.calib, event_capacity=rig.cap, z_near=0.2, z_far=1.2
    )
    eng.set_frame_filter(my_name)
    mine = eng.process_frame(pos)
    np.testing.assert_array_equal(ref.disp_map, np.asarray(mine.disp_map))
    np.testing.assert_array_equal(ref.frame_bgr, np.asarray(mine.frame_bgr))


def test_filtered_frame_bit_equal_last_per_xy(rig, ref_modules,
                                              ref_xmaps_disp):
    """last_per_xy on the jittered set: the forward duplicate scatter's
    executed winner is the stream-order last on every NumPy version
    observed, so full-path equality holds with real duplicate conflicts."""
    from xmaps.models.depth_pipeline import XMapsDepthEngine

    pos = rig.evs[rig.evs["p"] == 1]
    ref = _ref_frame(
        rig, ref_modules, ref_xmaps_disp, pos,
        ref_filter=ref_modules.fef.LastEventPerXYFilter(),
    )
    eng = XMapsDepthEngine.from_calibration(
        rig.calib, event_capacity=rig.cap, z_near=0.2, z_far=1.2
    )
    eng.set_frame_filter("last_per_xy")
    mine = eng.process_frame(pos)
    np.testing.assert_array_equal(ref.disp_map, np.asarray(mine.disp_map))
    np.testing.assert_array_equal(ref.frame_bgr, np.asarray(mine.frame_bgr))


@pytest.mark.parametrize("my_name,ref_name", _FILTER_PAIRS)
def test_filter_survivor_pixels_match(rig, ref_modules, my_name, ref_name):
    """The surviving pixel set is winner-independent and must match
    exactly on the jittered (conflicting) event set."""
    import jax

    from xmaps.ops.event_batch import EventBatch
    from xmaps.ops.filters import apply_frame_filter

    ref_filter = getattr(ref_modules.fef, ref_name)()
    evs = rig.evs[rig.evs["p"] == 1]  # upstream polarity filter (pipe)
    xr_all = np.asarray(rig.my_maps.disp_cam_mapx_i16)[
        evs["y"], evs["x"]
    ]
    ref_out = ref_filter.filter_events(evs, xr_all)

    batch = EventBatch.from_structured(evs, rig.cap)
    fb = apply_frame_filter(
        batch,
        jax.numpy.asarray(
            np.concatenate(
                [xr_all.astype(np.int32),
                 np.zeros(rig.cap - len(evs), np.int32)]
            )
        ),
        name=my_name,
        camera_width=rig.calib.camera_width,
        camera_height=rig.calib.camera_height,
        rect_width=rig.calib.rect_image_width,
    )
    keep = np.asarray(fb.batch.valid)[: len(evs)]
    assert keep.sum() == len(ref_out)
    if my_name == "first_per_yt":
        # the filter dedups on (raw y, rectified x); the reference
        # re-emits grid (y, xp) cells, so the survivors' raw x is
        # winner-dependent -- compare the per-y survivor counts (the
        # number of distinct occupied xp columns per row)
        mine_per_y = np.bincount(
            evs["y"][keep], minlength=rig.calib.camera_height
        )
        ref_per_y = np.bincount(
            ref_out["y"], minlength=rig.calib.camera_height
        )
        np.testing.assert_array_equal(ref_per_y, mine_per_y)
    else:
        mine_px = {
            (int(y), int(x))
            for y, x in zip(evs["y"][keep], evs["x"][keep])
        }
        ref_px = {
            (int(y), int(x)) for y, x in zip(ref_out["y"], ref_out["x"])
        }
        assert mine_px == ref_px


def test_first_per_xy_winner_is_stream_first(rig):
    """Pin xmaps's winner to the documented intent: the FIRST event
    per pixel in stream order (the reference's reversed-scatter idiom is
    numpy-version-dependent; see the section comment)."""
    import jax

    from xmaps.ops.event_batch import EventBatch
    from xmaps.ops.filters import apply_frame_filter

    batch = EventBatch.from_structured(rig.evs, rig.cap)
    fb = apply_frame_filter(
        batch,
        jax.numpy.zeros(rig.cap, jax.numpy.int32),
        name="first_per_xy",
        camera_width=rig.calib.camera_width,
        camera_height=rig.calib.camera_height,
        rect_width=rig.calib.rect_image_width,
    )
    keep = np.asarray(fb.batch.valid)[: len(rig.evs)]
    seen = set()
    for i, ev in enumerate(rig.evs):
        px = (int(ev["y"]), int(ev["x"]))
        if ev["p"] != 1:
            assert not keep[i]
            continue
        if px in seen:
            assert not keep[i], f"lane {i} is not the first event of {px}"
        else:
            assert keep[i], f"lane {i} IS the first event of {px}"
            seen.add(px)


# ---------------------------------------------------------------------------
# Trigger finder (trigger_finder.py:91-189), against the reference's own
# code with a minimal Metavision SDK shim (EventCDBuffer + the pool's
# PolarityFilterAlgorithm.get_empty_output_buffer)
# ---------------------------------------------------------------------------


class _FakeEventCDBuffer:
    def __init__(self, arr=None):
        self._arr = arr if arr is not None else np.zeros(0, _EV_DTYPE)

    def numpy(self):
        return self._arr

    def __len__(self):
        return len(self._arr)


_EV_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")]
)


class _FakePolarityFilter:
    @staticmethod
    def get_empty_output_buffer():
        return _FakeEventCDBuffer()


class _TfStats(_StatsShim):
    def __init__(self):
        self.counts = {}

    def count(self, name):
        self.counts[name] = self.counts.get(name, 0) + 1


@pytest.fixture(scope="module")
def ref_trigger_finder():
    _install_numba_shim()
    base = types.ModuleType("metavision_sdk_base")
    base.EventCD = _EV_DTYPE
    base.EventCDBuffer = _FakeEventCDBuffer
    core = types.ModuleType("metavision_sdk_core")
    core.PolarityFilterAlgorithm = _FakePolarityFilter
    # the reference's stats_printer no longer imports on Python 3.12
    # (mutable dataclass default); it is instrumentation, not the logic
    # under test, so substitute the shim
    stats_mod = types.ModuleType("stats_printer")
    stats_mod.StatsPrinter = _TfStats
    saved = {
        k: sys.modules.get(k)
        for k in (
            "metavision_sdk_base", "metavision_sdk_core", "stats_printer"
        )
    }
    sys.modules["metavision_sdk_base"] = base
    sys.modules["metavision_sdk_core"] = core
    sys.modules["stats_printer"] = stats_mod
    sys.path.insert(0, str(REF))
    try:
        import event_buf_pool as ref_pool
        import trigger_finder as ref_tf

        yield types.SimpleNamespace(tf=ref_tf, pool=ref_pool)
    finally:
        sys.path.remove(str(REF))
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _packet_stream(rig, n_frames=6, fps=60, rng_seed=2):
    """Frame-shaped packets: bursts separated by blanking gaps, delivered
    in T/4 arrival packets like the live pipe (depth_reprojection.py)."""
    from xmaps.utils.synthetic import simulate_sequence

    rng = np.random.default_rng(rng_seed)
    evs = simulate_sequence(
        rig.calib,
        [0.5 + 0.01 * i for i in range(n_frames)],
        fps=fps,
        subsample=0.9,
        rng=rng,
    )
    evs = evs.astype(_EV_DTYPE)
    dt = 1e6 / fps / 4
    t0 = evs["t"][0]
    packets, start = [], 0
    k = 1
    for i in range(len(evs)):
        if evs["t"][i] - t0 >= k * dt:
            packets.append(evs[start:i])
            start = i
            k += 1
    packets.append(evs[start:])
    return [p for p in packets if len(p)]


def test_trigger_finder_frames_bit_equal(rig, ref_trigger_finder):
    from xmaps.runtime.trigger_finder import RobustTriggerFinder
    from xmaps.utils.stats import StatsPrinter

    packets = _packet_stream(rig)
    assert len(packets) >= 12

    ref_frames = []
    pool = ref_trigger_finder.pool.EventBufPool()
    ref = ref_trigger_finder.tf.RobustTriggerFinder(
        projector_fps=60,
        stats=_TfStats(),
        frame_callback=lambda evs: ref_frames.append(np.array(evs)),
        pool=pool,
    )
    mine_frames = []
    mine = RobustTriggerFinder(
        projector_fps=60,
        stats=StatsPrinter(silent=True),
        frame_callback=lambda evs: mine_frames.append(np.array(evs)),
    )
    for p in packets:
        ref.process_events(_FakeEventCDBuffer(p))
        mine.process_events(p)

    # Documented deviation (runtime/trigger_finder.py find_trigger tail):
    # when a scan finds fewer than two pauses, the reference pops the
    # whole buffer and NEVER pushes it back (trigger_finder.py:148-189 --
    # the for loop falls through to `return -1` after pop_all), silently
    # dropping every buffered event.  On a clean 4-packets/frame stream
    # this loses most frames to startup/phase luck (observed here: 1 of
    # ~5 emitted).  xmaps keeps the tail from the last pause onward
    # instead.  The boundary RULES are identical, so every frame the
    # reference does emit must be bit-identical to one of ours.
    assert len(mine_frames) >= 4, f"only {len(mine_frames)} frames"
    assert 1 <= len(ref_frames) <= len(mine_frames)
    mine_by_start = {int(f["t"][0]): f for f in mine_frames}
    for a in ref_frames:
        b = mine_by_start.get(int(a["t"][0]))
        assert b is not None, f"reference frame at t={a['t'][0]} not emitted"
        np.testing.assert_array_equal(a, b.astype(a.dtype))


# ---------------------------------------------------------------------------
# Biases (biases.py:1-76) -- pure-stdlib module, imported directly
# ---------------------------------------------------------------------------


def test_biases_differential(tmp_path):
    sys.path.insert(0, str(REF))
    try:
        import biases as ref_biases
    finally:
        sys.path.remove(str(REF))
    from xmaps.io import biases as my_biases

    bias_file = tmp_path / "cam.bias"
    bias_file.write_text(
        "300   % bias_diff\n225 % bias_diff_off\n"
        "  1700 % bias_refr\n\n% comment only\n"
    )
    ref_loaded = ref_biases.load_bias_file(str(bias_file))
    my_loaded = my_biases.load_bias_file(str(bias_file))
    assert ref_loaded == my_loaded

    rb = ref_biases.Biases()
    mb = my_biases.Biases()
    assert rb.biases == mb.biases
    assert rb.biases_limits == mb.biases_limits
    # drive the same interaction sequence through both: cycle + clamped
    # inc/dec at every bias
    rng = np.random.default_rng(0)
    for step in rng.integers(1, 400, 50):
        assert rb.cycle_current_bias() == mb.cycle_current_bias()
        assert rb.increase_current(int(step)) == mb.increase_current(int(step))
        assert rb.decrease_current(int(step * 2)) == mb.decrease_current(
            int(step * 2)
        )
    assert rb.biases == mb.biases
