"""Host staging pool: packed staging equivalence, in-place reuse, and the
staged frame program."""

import numpy as np
import pytest

from xmaps.io.evt_decoder import EVENT_DTYPE
from xmaps.io.prefetch import HostStagingPool, unpack_staged
from xmaps.ops.event_batch import EventBatch

def _unpack_bgrx(frame):
    """Host view of the packed u32 display plane as (H, W, 3) u8."""
    arr = np.asarray(frame)
    if arr.dtype == np.uint32:
        h, w = arr.shape
        return arr.view(np.uint8).reshape(h, w, 4)[..., :3]
    return arr



def _events(rng, n, t0=1_000_000):
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = t0 + np.sort(rng.integers(0, 16_000, n))
    return ev


@pytest.mark.parametrize("sizes", [(100, 700, 300), (512, 512), (600, 0, 10)])
def test_stage_matches_from_structured(sizes, rng):
    """unpack_staged(stage(ev)) must equal EventBatch.from_structured."""
    import jax

    cap = 512
    pool = HostStagingPool(cap, depth=2)
    unpack = jax.jit(unpack_staged)
    for i, n in enumerate(sizes):
        ev = _events(rng, n, t0=1_000_000 * (i + 1))
        got = unpack(pool.stage(ev))
        want = EventBatch.from_structured(ev, cap)
        for field in EventBatch._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, field)),
                np.asarray(getattr(want, field)),
                err_msg=f"{field} differs at frame {i} (n={n})",
            )
    assert pool.frames_staged == len(sizes)
    assert pool.events_truncated == sum(max(0, n - cap) for n in sizes)


def test_host_buffers_are_reused(rng):
    pool = HostStagingPool(256, depth=2)
    ids0 = {k: id(v) for k, v in pool._slots[0].items()}
    for i in range(6):
        pool.stage(_events(rng, 100 + i))
    assert {k: id(v) for k, v in pool._slots[0].items()} == ids0


def test_stale_slot_contents_never_leak(rng):
    """A short frame staged into a slot that previously held a long frame
    must not expose the long frame's tail."""
    cap = 512
    pool = HostStagingPool(cap, depth=2)
    pool.stage(_events(rng, 500))  # slot 0, long
    pool.stage(_events(rng, 400))  # slot 1
    short = _events(rng, 5)
    got = unpack_staged(pool.stage(short))  # slot 0 again, short
    assert int(got.count) == 5
    assert not np.asarray(got.valid)[5:].any()
    assert np.asarray(got.x)[5:].sum() == 0


def test_host_time_binning_matches_device_exactly(rng):
    """_scale_time_int_host must reproduce the device integer
    round-half-to-even bit for bit, including exact .5 ties."""
    import jax.numpy as jnp

    from xmaps.io.prefetch import _scale_time_int_host
    from xmaps.ops.disparity import _scale_time_int

    scale = 719
    # random frames + a constructed tie: rng divides 2*scale so some
    # (t - min) * scale land exactly on half-bins
    frames = [
        np.sort(rng.integers(0, 16_700, 4096)).astype(np.int64),
        np.arange(0, 2 * scale + 1, 1, dtype=np.int64),  # rng = 2*scale
    ]
    for t in frames:
        host = _scale_time_int_host(t, scale)
        dev = np.asarray(
            _scale_time_int(
                jnp.asarray(t - t.min(), jnp.int32),
                jnp.int32(0),
                jnp.int32(t.max() - t.min()),
                scale,
            )
        )
        np.testing.assert_array_equal(host, dev)


def test_compact_stage_matches_two_word_path():
    """The 1-word compact staging must produce bit-identical frames to
    the 2-word staging and the EventBatch path (frame_filter none)."""
    from xmaps.io.prefetch import CompactLayout
    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration()
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=8192, z_near=0.2, z_far=1.2
    )
    assert engine.compact_layout is not None
    lay = engine.compact_layout
    assert lay.bits_x + lay.bits_y + lay.bits_t <= 32
    pool = HostStagingPool(
        engine.cfg.event_capacity, depth=2, layout=engine.compact_layout
    )
    for z in (0.5, 0.7):
        ev = simulate_plane_events(calib, depth_m=z, subsample=0.4)
        got = engine.process_staged(pool.stage_compact(ev))
        via2 = engine.process_staged(pool.stage(ev))
        want = engine.process_batch_device(engine.make_batch(ev))
        # staged programs run display-only (reference output surface):
        # depth/disp_map are absent, the frame must still be bit-exact
        assert got.depth is None and got.disp_map is None
        for ref in (via2, want):
            np.testing.assert_array_equal(
                _unpack_bgrx(got.frame_bgr), _unpack_bgrx(ref.frame_bgr)
            )
            assert int(got.num_inliers) == int(ref.num_inliers)


def test_compact_layout_rejects_oversize_dims():
    from xmaps.config import PipelineConfig
    from xmaps.io.prefetch import CompactLayout

    cfg = PipelineConfig(
        camera_width=4096,
        camera_height=4096,
        projector_width=4096,
        projector_height=4096,
        rect_width=64,
        rect_height=64,
        p03=100.0,
        event_capacity=256,
        z_near=0.1,
        z_far=1.0,
    )
    assert CompactLayout.for_pipeline(cfg) is None


def test_staged_frame_path_runs():
    """engine.process_staged on pool-staged frames must match the
    EventBatch path bit for bit."""
    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration()
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=8192, z_near=0.2, z_far=1.2
    )
    pool = HostStagingPool(engine.cfg.event_capacity, depth=2)
    for z in (0.5, 0.7):
        ev = simulate_plane_events(calib, depth_m=z, subsample=0.4)
        got = engine.process_staged(pool.stage(ev))
        want = engine.process_batch_device(engine.make_batch(ev))
        assert got.depth is None  # staged programs are display-only
        np.testing.assert_array_equal(
            _unpack_bgrx(got.frame_bgr), np.asarray(want.frame_bgr)
        )
        assert int(got.num_inliers) == int(want.num_inliers)


def _ring_events(rng, n, t0=5_000_000):
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = t0 + np.sort(rng.integers(0, 50_000, n))
    return ev


def test_ring_assembly_bit_identical(rng):
    """A frame assembled on device from pre-staged packet slots must equal
    EventBatch.from_structured of the segmented slice, bit for bit --
    including packet splitting, mid-packet frame boundaries and padding."""
    import jax

    from xmaps.io.prefetch import (
        RING_SLOTS_PER_FRAME as K,
        PacketRing,
        assemble_ring_frame,
    )

    ev = _ring_events(rng, 5000)
    ring = PacketRing(packet_capacity=800, n_slots=16)
    offs = [0, 700, 1500, 2100, 3000, 3900, 4400, 5000]
    for a, b in zip(offs[:-1], offs[1:]):
        assert ring.stage_packets(ev[a:b])

    cap = 4096
    fn = jax.jit(lambda a, b, m: assemble_ring_frame(a, b, m, cap))
    # note: the 900-event arrival packets split into 800+100, so the
    # global range must touch at most RING_SLOTS_PER_FRAME=8 packets;
    # meta is (3, k) for the frame's actual packet count k
    for gs, ge in [(950, 4200), (0, 700), (702, 800), (100, 4390)]:
        frame = ev[gs:ge]
        out = ring.frame_meta(gs, ge, int(frame["t"][0]))
        assert out is not None, (gs, ge)
        pkts, meta = out
        assert meta.shape == (3, len(pkts)) and len(pkts) <= K
        xys = tuple(p.xy for p in pkts)
        tps = tuple(p.tp for p in pkts)
        got = fn(xys, tps, meta)
        want = EventBatch.from_structured(frame, cap)
        for f in EventBatch._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)),
                np.asarray(getattr(want, f)),
                err_msg=f"{f} differs for frame [{gs}, {ge})",
            )


def test_ring_assembly_compact_bit_identical(rng):
    """Compact (one-word RingLayout) ring staging must assemble the same
    batch as EventBatch.from_structured of the segmented slice -- with p
    reconstructed as the 1 the upstream polarity filter guarantees."""
    import jax

    from xmaps.io.prefetch import (
        PacketRing,
        RingLayout,
        assemble_ring_frame_compact,
    )

    layout = RingLayout.for_camera(640, 480)
    assert layout is not None and layout.bits_t == 13

    ev = _ring_events(rng, 5000)
    ev["p"] = 1  # post-polarity-filter stream (the layout's contract)
    ring = PacketRing(packet_capacity=800, n_slots=16, layout=layout)
    offs = [0, 700, 1500, 2100, 3000, 3900, 4400, 5000]
    for a, b in zip(offs[:-1], offs[1:]):
        assert ring.stage_packets(ev[a:b])

    cap = 4096
    fn = jax.jit(
        lambda ws, m: assemble_ring_frame_compact(ws, m, cap, layout)
    )
    for gs, ge in [(950, 4200), (0, 700), (702, 800), (100, 4390)]:
        frame = ev[gs:ge]
        out = ring.frame_meta(gs, ge, int(frame["t"][0]))
        assert out is not None, (gs, ge)
        pkts, meta = out
        assert all(p.tp is None for p in pkts)
        got = fn(tuple(p.xy for p in pkts), meta)
        want = EventBatch.from_structured(frame, cap)
        for f in EventBatch._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, f)),
                np.asarray(getattr(want, f)),
                err_msg=f"{f} differs for frame [{gs}, {ge})",
            )


def test_ring_compact_splits_long_spans(rng):
    """A staged chunk spanning more than 2^bits_t us must split so every
    packet's t_rel fits the layout's field -- and still assemble exactly."""
    import jax

    from xmaps.io.prefetch import (
        PacketRing,
        RingLayout,
        assemble_ring_frame_compact,
    )

    layout = RingLayout.for_camera(640, 480)
    n = 3000
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, 640, n)
    ev["y"] = rng.integers(0, 480, n)
    ev["p"] = 1
    # ~20 ms span: > 2x the 8.192 ms t_rel field
    ev["t"] = 1_000_000 + np.sort(rng.integers(0, 20_000, n))
    ring = PacketRing(packet_capacity=4096, n_slots=16, layout=layout)
    assert ring.stage_packets(ev)
    assert ring.packets_staged >= 3  # split by span, not capacity

    cap = 4096
    out = ring.frame_meta(0, n, int(ev["t"][0]))
    assert out is not None
    pkts, meta = out
    got = jax.jit(
        lambda ws, m: assemble_ring_frame_compact(ws, m, cap, layout)
    )(tuple(p.xy for p in pkts), meta)
    want = EventBatch.from_structured(ev, cap)
    for f in EventBatch._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f,
        )


def test_ring_assembly_frame_larger_than_capacity(rng):
    """A frame spanning more events than the batch capacity must truncate
    exactly like EventBatch.from_structured -- including a packet that
    straddles the capacity boundary (the shift-copy placement clamps its
    output offset into the scratch tail)."""
    import jax

    from xmaps.io.prefetch import PacketRing, assemble_ring_frame

    ev = _ring_events(rng, 3000)
    ring = PacketRing(packet_capacity=700, n_slots=16)
    for a in range(0, 3000, 700):
        assert ring.stage_packets(ev[a : a + 700])

    cap = 1500  # frame of 2600 events straddles packet 3 mid-slot
    out = ring.frame_meta(100, 2700, int(ev["t"][100]))
    assert out is not None
    pkts, meta = out
    got = jax.jit(
        lambda a, b, m: assemble_ring_frame(a, b, m, cap)
    )(tuple(p.xy for p in pkts), tuple(p.tp for p in pkts), meta)
    want = EventBatch.from_structured(ev[100:2700], cap)
    for f in EventBatch._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f,
        )


def test_ring_overrun_and_retire(rng):
    from xmaps.io.prefetch import PacketRing

    ring = PacketRing(packet_capacity=64, n_slots=16)
    ev = _ring_events(rng, 64 * 16)
    assert ring.stage_packets(ev)  # fills all 16 slots
    extra = _ring_events(rng, 10)
    assert not ring.stage_packets(extra)  # overrun, numbering still advances
    assert ring.overruns == 1
    # the unstaged range is reported as a hole
    assert ring.frame_meta(64 * 16, 64 * 16 + 10, 0) is None
    # numbering stays aligned: the next staged packet lands after the hole
    ring.retire_below(64 * 4)
    assert len(ring._free) == 4
    more = _ring_events(rng, 30)
    assert ring.stage_packets(more)
    pkts, meta = ring.frame_meta(
        64 * 16 + 10, 64 * 16 + 40, int(more["t"][0])
    )
    assert pkts[0].gbase == 64 * 16 + 10 and pkts[0].count == 30


def test_ring_frame_meta_rejects_too_many_packets(rng):
    from xmaps.io.prefetch import PacketRing

    ring = PacketRing(packet_capacity=16, n_slots=32)
    ev = _ring_events(rng, 16 * 9)
    assert ring.stage_packets(ev)  # 9 packets > RING_SLOTS_PER_FRAME
    assert ring.frame_meta(0, 16 * 9, int(ev["t"][0])) is None
    # but an 8-packet window works
    assert ring.frame_meta(0, 16 * 8, int(ev["t"][0])) is not None
