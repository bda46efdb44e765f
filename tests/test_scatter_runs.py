"""The sort-free "runs" scatter (host target-sorted batches) vs the
duplicate-capable "max" oracle.

The runs method's contract (ops.scatter): same-target lanes contiguous
among real lanes, each run ordered [scatter-rejects..., kept lanes in
ascending priority] (the host mirrors the scatter's exact ``ok`` mask
into its sort key), run keys defined for every lane, winner = the run's
last kept lane (one neighbor compare on device).  These tests force the
hazardous configurations: duplicate targets, rejected lanes inside runs,
all-reject runs, out-of-window targets, and padding lanes at the tail
whose keys coincide with real runs (non-contiguous key repeats --
harmless because the winner test is local and padding never wins).
"""

import numpy as np
import pytest

from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import depth_frame
from xmaps.ops.scatter import scatter_disp_packed
from xmaps.utils.synthetic import (
    make_synthetic_calibration,
    simulate_plane_events,
)

CAPACITY = 2048


def _runs_case(rng, n_real, cap, h, w, key_space, window):
    """Host-sorted lanes with dense target collisions + reject lanes
    inside runs, padded to cap with key-coincident padding lanes.

    Mirrors the host's sort contract: within each run the lanes the
    scatter will REJECT (the exact ok mask: inlier, window bounds, disp
    range) come first, kept lanes follow in ascending priority."""
    from xmaps.ops.scatter import PACK

    ky = rng.integers(0, key_space[0], n_real)
    kx = rng.integers(0, key_space[1], n_real)
    disp = rng.integers(0, 500, n_real)
    inlier = rng.random(n_real) < 0.7  # rejects inside runs
    prio = rng.permutation(n_real).astype(np.int32)
    # the scatter's exact ok mask, mirrored like the host does
    oy, ox, wh, ww = window if window else (0, 0, h, w)
    ok = (
        inlier
        & (ky >= oy) & (ky < oy + wh)
        & (kx >= ox) & (kx < ox + ww)
        & (disp >= 0) & (disp < PACK)
    )
    order = np.lexsort((prio, ok, kx, ky))
    ky, kx, disp, inlier, prio = (
        ky[order], kx[order], disp[order], inlier[order], prio[order]
    )

    pad = cap - n_real
    # padding tail repeats real keys non-contiguously; never inlier
    pk = rng.integers(0, n_real, pad)
    ys = np.concatenate([ky, ky[pk]]).astype(np.int32)
    xs = np.concatenate([kx, kx[pk]]).astype(np.int32)
    disp = np.concatenate([disp, np.zeros(pad)]).astype(np.float32)
    inlier = np.concatenate([inlier, np.zeros(pad, bool)])
    prio = np.concatenate([prio, np.zeros(pad, np.int32)])
    return ys, xs, disp, inlier, prio


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [None, (2, 3, 40, 50)])
def test_runs_matches_max_oracle(seed, window):
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    ys, xs, disp, inlier, prio = _runs_case(
        rng, n_real=1500, cap=CAPACITY, h=h, w=w, key_space=(h + 4, w + 4),
        window=window,
    )
    kw = dict(
        height=h,
        width=w,
        priority=prio,
        pad_shape=(64, 128) if window else None,
        window=window,
    )
    ref = scatter_disp_packed(
        ys, xs, disp, inlier, method="max", **kw
    )
    got = scatter_disp_packed(
        ys, xs, disp, inlier, method="runs", run_keys=(ys, xs), **kw
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    # the device-sorted strategy resolves the same winners in any order
    srt = scatter_disp_packed(ys, xs, disp, inlier, method="sorted", **kw)
    np.testing.assert_array_equal(np.asarray(srt), np.asarray(ref))


def test_runs_all_reject_run():
    """A run whose every lane is rejected must leave its pixel at 0."""
    ys = np.array([3, 3, 3, 5], np.int32)
    xs = np.array([7, 7, 7, 1], np.int32)
    disp = np.array([4.0, 9.0, 2.0, 1.0], np.float32)
    inlier = np.array([False, False, False, True])
    prio = np.array([0, 1, 2, 3], np.int32)
    out = scatter_disp_packed(
        ys, xs, disp, inlier, height=8, width=8,
        priority=prio, method="runs", run_keys=(ys, xs),
    )
    out = np.asarray(out)
    assert out[3, 7] == 0
    assert out[5, 1] != 0


def _cfg(engine, use_crop):
    """The engine's config with its tail crop window, or without one (the
    full rect frame)."""
    return engine.cfg if use_crop else engine.cfg.replace(tail_crop=None)


@pytest.mark.parametrize("camera_perspective", [False, True])
@pytest.mark.parametrize("use_crop", [False, True])
def test_engine_target_sorted_frame_bit_exact(camera_perspective, use_crop):
    """make_sorted_batch's target key + depth_frame presort_runs must
    reproduce the arrival-order frame bit-for-bit, with and without the
    crop window, with duplicated events forcing same-target runs."""
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.25, jitter_us=2.0,
        rng=np.random.default_rng(5),
    )
    # duplicate a stride so many pixels get >= 2 candidate events with
    # distinct priorities (the duplicate, arriving later, must win)
    events = np.concatenate([events, events[::5]])[: CAPACITY - 64]

    engine.cfg = _cfg(engine, use_crop)  # the host key mirrors the window
    b, prio = engine.make_sorted_batch(events)
    ref = depth_frame(
        EventBatch.from_structured(events, CAPACITY),
        engine.tables, engine.cfg.replace(tail_crop=None),
    )
    got = depth_frame(
        b, engine.tables, engine.cfg,
        presort_priority=prio, presort_runs=True,
    )
    np.testing.assert_array_equal(
        np.asarray(got.disp_map), np.asarray(ref.disp_map)
    )
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_presort_runs_requires_host_sort():
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.1, jitter_us=2.0,
        rng=np.random.default_rng(7),
    )
    with pytest.raises(ValueError, match="presort_runs"):
        depth_frame(
            EventBatch.from_structured(events, CAPACITY),
            engine.tables, engine.cfg, presort_runs=True,
        )
    # a host priority needs integer timestamps and no frame filter
    b, prio = engine.make_sorted_batch(events)
    with pytest.raises(ValueError, match="presort_priority"):
        depth_frame(
            b, engine.tables, engine.cfg.replace(frame_filter="first_per_xy"),
            presort_priority=prio,
        )


@pytest.mark.parametrize("use_crop", [False, True])
def test_compact_presort_staging_bit_exact(use_crop):
    """Host target-sorted compact staging (HostStagingPool presort_fn +
    lane-index priorities) must reproduce the arrival-order program
    bit-for-bit with and without the crop window, duplicates included."""
    import jax.numpy as jnp

    from xmaps.io.prefetch import (
        CompactLayout,
        HostStagingPool,
        unpack_staged_compact,
    )

    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.25, jitter_us=2.0,
        rng=np.random.default_rng(9),
    )
    events = np.concatenate([events, events[::4]])[: CAPACITY - 32]
    engine.cfg = _cfg(engine, use_crop)

    layout = CompactLayout.for_pipeline(engine.cfg)
    assert layout is not None
    pool = HostStagingPool(
        CAPACITY, depth=2, layout=layout,
        presort_fn=engine.compact_presort,
    )
    staged = pool.stage_compact(events)
    assert staged.presorted

    batch, ts = unpack_staged_compact(staged, layout)
    got = depth_frame(
        batch, engine.tables, engine.cfg,
        t_scaled=ts,
        presort_priority=jnp.arange(CAPACITY, dtype=jnp.int32),
        presort_runs=True,
    )
    ref = depth_frame(
        EventBatch.from_structured(events, CAPACITY),
        engine.tables, engine.cfg.replace(tail_crop=None),
    )
    np.testing.assert_array_equal(
        np.asarray(got.disp_map), np.asarray(ref.disp_map)
    )
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(got.num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("camera_perspective", [False, True])
@pytest.mark.parametrize("use_crop", [False, True])
def test_host_ok_mirror_matches_device(camera_perspective, use_crop):
    """The host sort key's low bit must equal the scatter's exact keep
    mask (run winner = last kept lane relies on it; a mismatch is a
    unique-indices violation the bit-exact tests could mask as UB)."""
    import jax.numpy as jnp

    from xmaps.config import X_OFFSET
    from xmaps.io.prefetch import _scale_time_int_host
    from xmaps.ops.disparity import compute_event_disparity
    from xmaps.ops.scatter import PACK

    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
    )
    if not use_crop:
        engine.cfg = engine.cfg.replace(tail_crop=None)
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.3, jitter_us=2.0,
        rng=np.random.default_rng(13),
    )
    events = np.concatenate([events, events[::3]])[: CAPACITY - 16]
    n = len(events)

    ts = _scale_time_int_host(events["t"], engine.cfg.t_px_scale)
    key, _ = engine._host_target_key(events, ts)
    host_ok = (np.asarray(key) & 1).astype(bool)

    # device-side keep mask, reconstructed from the disparity stage the
    # same way ops.frame_pipeline + ops.scatter apply it
    batch = EventBatch.from_structured(events, n)
    res = compute_event_disparity(
        batch,
        engine.tables.cam_mapx_i16,
        engine.tables.cam_mapy_i16,
        engine.tables.x_map,
        t_px_scale=engine.cfg.t_px_scale,
        t_scaled=jnp.asarray(ts),
    )
    disp_i = np.asarray(res.disp).astype(np.int64)
    inlier = np.asarray(res.inlier)
    if camera_perspective:
        ys, xs = events["y"].astype(np.int64), events["x"].astype(np.int64)
        oy = ox = 0
        wh, ww = engine.cfg.camera_height, engine.cfg.camera_width
    else:
        ys = np.asarray(res.y_rect).astype(np.int64)
        xs = np.asarray(res.x_proj).astype(np.int64) - X_OFFSET
        oy, ox, wh, ww = engine.cfg.tail_crop or (
            0, 0, engine.cfg.rect_height, engine.cfg.rect_width
        )
    dev_ok = (
        inlier
        & (ys - oy >= 0) & (ys - oy < wh)
        & (xs - ox >= 0) & (xs - ox < ww)
        & (disp_i >= 0) & (disp_i < PACK)
    )
    assert dev_ok.any() and not dev_ok.all(), "test needs both classes"
    np.testing.assert_array_equal(host_ok, dev_ok)


def test_runs_single_run_whole_array():
    """Every lane one run (the jnp.roll wraparound case: no key boundary
    anywhere, the forced final-lane boundary must crown the last kept
    lane), rejects first per the contract."""
    n = 16
    ys = np.full(n, 5, np.int32)
    xs = np.full(n, 9, np.int32)
    disp = np.arange(n).astype(np.float32)
    inlier = np.ones(n, bool)
    inlier[:3] = False  # rejects sort first; kept lanes ascending prio
    prio = np.arange(n, dtype=np.int32)
    out = np.asarray(scatter_disp_packed(
        ys, xs, disp, inlier, height=8, width=16,
        priority=prio, method="runs", run_keys=(ys, xs),
    ))
    from xmaps.ops.scatter import PACK
    assert out[5, 9] == (n - 1 + 1) * PACK + (n - 1)
    assert (out != 0).sum() == 1


def test_runs_all_padding():
    """All lanes padding (packed == 0): the map must stay empty."""
    n = 8
    z = np.zeros(n, np.int32)
    out = np.asarray(scatter_disp_packed(
        z, z, z.astype(np.float32), np.zeros(n, bool),
        height=4, width=4, priority=z, method="runs", run_keys=(z, z),
    ))
    assert (out == 0).all()


def test_runs_trailing_padding_extends_last_run():
    """Padding lanes sharing the LAST real run's key must not hide its
    winner (the winner's successor carries packed == 0)."""
    ys = np.array([2, 2, 2, 2], np.int32)
    xs = np.array([3, 3, 3, 3], np.int32)
    disp = np.array([7.0, 8.0, 0.0, 0.0], np.float32)
    inlier = np.array([True, True, False, False])  # last two = padding
    prio = np.array([0, 1, 0, 0], np.int32)
    out = np.asarray(scatter_disp_packed(
        ys, xs, disp, inlier, height=4, width=4,
        priority=prio, method="runs", run_keys=(ys, xs),
    ))
    from xmaps.ops.scatter import PACK
    assert out[2, 3] == 2 * PACK + 8


def test_make_sorted_batch_rejects_float_timestamps():
    """Float-t streams must be rejected (int64 staging would silently
    truncate them and the host cannot mirror float time binning);
    integer streams stage as (batch, arrival priorities)."""
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.1, jitter_us=2.0,
        rng=np.random.default_rng(3),
    )
    b, prio = engine.make_sorted_batch(events)
    n = len(events)
    assert sorted(np.asarray(prio)[:n].tolist()) == list(range(n))

    fdtype = [("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<f8")]
    fevents = np.zeros(len(events), dtype=fdtype)
    for f in ("x", "y", "p"):
        fevents[f] = events[f]
    fevents["t"] = events["t"].astype(np.float64) * 1e-6
    with pytest.raises(ValueError, match="integer timestamps"):
        engine.make_sorted_batch(fevents)


def test_process_frames_float_t_falls_back_to_unsorted():
    """process_frames with float-t frames must skip host presorting (the
    runs scatter contract cannot hold) and still match process_frame."""
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.15, jitter_us=2.0,
        rng=np.random.default_rng(11),
    )
    fdtype = [("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<f8")]
    fevents = np.zeros(len(events), dtype=fdtype)
    for f in ("x", "y", "p"):
        fevents[f] = events[f]
    fevents["t"] = events["t"].astype(np.float64)

    group = engine.process_frames([fevents])
    assert list(engine._group_cache) == [(1, False)]
    ref = engine.process_frame(fevents)
    np.testing.assert_array_equal(
        np.asarray(group[0].depth), np.asarray(ref.depth)
    )
    np.testing.assert_array_equal(
        np.asarray(group[0].frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(group[0].num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("camera_perspective", [False, True])
def test_host_target_key_corrupt_coordinates(camera_perspective):
    """Out-of-range x/y (a malformed/corrupt stream) must not raise in
    host staging, and the host ok bit must still equal the device keep
    mask (the device clips LUT indices; the host mirrors that)."""
    import jax.numpy as jnp

    from xmaps.config import X_OFFSET
    from xmaps.io.prefetch import _scale_time_int_host
    from xmaps.ops.disparity import compute_event_disparity
    from xmaps.ops.scatter import PACK

    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.2, jitter_us=2.0,
        rng=np.random.default_rng(29),
    ).copy()
    # corrupt a stride of lanes with out-of-range coordinates
    events["x"][::7] = engine.cfg.camera_width + 50
    events["y"][::11] = engine.cfg.camera_height + 7
    n = len(events)

    ts = _scale_time_int_host(events["t"], engine.cfg.t_px_scale)
    key, _ = engine._host_target_key(events, ts)  # must not raise
    host_ok = (np.asarray(key) & 1).astype(bool)

    batch = EventBatch.from_structured(events, n)
    res = compute_event_disparity(
        batch,
        engine.tables.cam_mapx_i16,
        engine.tables.cam_mapy_i16,
        engine.tables.x_map,
        t_px_scale=engine.cfg.t_px_scale,
        t_scaled=jnp.asarray(ts),
    )
    disp_i = np.asarray(res.disp).astype(np.int64)
    inlier = np.asarray(res.inlier)
    if camera_perspective:
        ys, xs = events["y"].astype(np.int64), events["x"].astype(np.int64)
        oy = ox = 0
        wh, ww = engine.cfg.camera_height, engine.cfg.camera_width
    else:
        ys = np.asarray(res.y_rect).astype(np.int64)
        xs = np.asarray(res.x_proj).astype(np.int64) - X_OFFSET
        oy, ox, wh, ww = engine.cfg.tail_crop
    dev_ok = (
        inlier
        & (ys - oy >= 0) & (ys - oy < wh)
        & (xs - ox >= 0) & (xs - ox < ww)
        & (disp_i >= 0) & (disp_i < PACK)
    )
    np.testing.assert_array_equal(host_ok, dev_ok)


@pytest.mark.parametrize("camera_perspective", [False, True])
@pytest.mark.parametrize("use_crop", [False, True])
def test_winner_batch_bit_exact(camera_perspective, use_crop):
    """Host winner compaction (make_winner_batch + presort_unique) must
    reproduce the full-batch frame bit-for-bit -- same packed winners
    (original arrival priorities), same disp/depth/frame, and the
    host-mirrored num_inliers equal to the device count over the full
    frame."""
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.25, jitter_us=2.0,
        rng=np.random.default_rng(17),
    )
    # duplicates force contested pixels whose LAST arrival must win
    events = np.concatenate([events, events[::4]])[: CAPACITY - 32]
    engine.cfg = _cfg(engine, use_crop)

    wb = engine.make_winner_batch(events)
    batch_w, ts_w, prio_w, n_inl = wb
    assert batch_w.x.shape[0] <= CAPACITY

    ref = depth_frame(
        EventBatch.from_structured(events, CAPACITY),
        engine.tables, engine.cfg.replace(tail_crop=None),
    )
    got = depth_frame(
        batch_w, engine.tables, engine.cfg,
        t_scaled=ts_w,
        presort_priority=prio_w,
        presort_unique=True, host_num_inliers=n_inl,
    )
    np.testing.assert_array_equal(
        np.asarray(got.disp_map), np.asarray(ref.disp_map)
    )
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_winner_batch_empty_frame():
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.1, rng=np.random.default_rng(1),
    )[:0]
    wb = engine.make_winner_batch(events)
    batch_w, ts_w, prio_w, n_inl = wb
    assert n_inl == 0
    got = depth_frame(
        batch_w, engine.tables, engine.cfg,
        t_scaled=ts_w, presort_priority=prio_w,
        presort_unique=True, host_num_inliers=n_inl,
    )
    assert int(got.num_inliers) == 0
    assert (np.asarray(got.disp_map) == 0).all()


def test_winner_batch_requires_integer_t():
    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    ev = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.1, rng=np.random.default_rng(2),
    )
    f = np.zeros(len(ev), dtype=[("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<f8")])
    for k in ("x", "y", "p"):
        f[k] = ev[k]
    f["t"] = ev["t"].astype(np.float64)
    with pytest.raises(ValueError, match="integer timestamps"):
        engine.make_winner_batch(f)
