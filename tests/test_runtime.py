"""End-to-end streaming runtime tests: RAW file -> packets -> trigger
finder -> device frames (the deterministic-replay smoke test of the
reference, SURVEY.md §4.2)."""

import numpy as np
import pytest

from xmaps.config import RuntimeParams
from xmaps.io.evt_encode import encode_evt2
from xmaps.io.event_iterator import FileEventsIterator
from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.runtime.processor import DepthReprojectionProcessor
from xmaps.runtime.pipe import DepthReprojectionPipe
from xmaps.runtime.trigger_finder import RobustTriggerFinder
from xmaps.utils.stats import StatsPrinter
from xmaps.utils.synthetic import (
    make_synthetic_calibration,
    simulate_sequence,
)

FPS = 60


@pytest.fixture(scope="module")
def calib():
    return make_synthetic_calibration()


@pytest.fixture(scope="module")
def raw_file(tmp_path_factory, calib):
    depths = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75]
    events = simulate_sequence(calib, depths, fps=FPS, subsample=0.6)
    path = tmp_path_factory.mktemp("seq") / "seq.raw"
    with open(path, "wb") as f:
        f.write(encode_evt2(events, calib.camera_width, calib.camera_height))
    return str(path), depths, events


def test_trigger_finder_segments_frames(raw_file, calib):
    path, depths, events = raw_file
    frames = []
    tf = RobustTriggerFinder(
        projector_fps=FPS,
        stats=StatsPrinter(silent=True),
        frame_callback=lambda evs: frames.append(evs.copy()),
    )
    delta_t = 1e6 / FPS / 4
    for packet in FileEventsIterator(path, delta_t=delta_t):
        tf.process_events(packet)

    # all interior frames are recoverable (boundary frames lack a leading/
    # trailing pause)
    assert len(frames) >= len(depths) - 2
    frame_us = 1e6 / FPS
    for f in frames:
        span = f["t"][-1] - f["t"][0]
        assert frame_us / 2 < span <= frame_us
        assert len(f) > 1000


def _make_processor(calib, prestage=True):
    """Headless processor with a prebuilt engine (the test calibration has
    no YAML file); returns (proc, shown_frames)."""
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=16384, z_near=0.2, z_far=1.2
    )
    params = RuntimeParams(
        camera_width=calib.camera_width,
        camera_height=calib.camera_height,
        projector_width=calib.projector_width,
        projector_height=calib.projector_height,
        projector_fps=FPS,
        z_near=0.2,
        z_far=1.2,
        calib="<in-memory>",
        no_frame_dropping=True,
    )
    shown = []
    proc = DepthReprojectionProcessor(
        params=params, stats_printer=StatsPrinter(silent=True)
    )
    proc._pipe = DepthReprojectionPipe(
        params=params,
        stats_printer=proc.stats_printer,
        frame_callback=lambda img: shown.append(img),
        engine=engine,
        prestage=prestage,
    )
    from xmaps.runtime.processor import FakeWindow

    proc._window = FakeWindow()
    return proc, shown


def test_full_processor_replay(raw_file, calib):
    path, depths, events = raw_file
    proc, shown = _make_processor(calib)
    delta_t = 1e6 / FPS / 4
    for packet in FileEventsIterator(path, delta_t=delta_t):
        proc.process_events(packet)
    proc._pipe.flush()

    assert len(shown) >= len(depths) - 2
    img = shown[0]
    assert img.shape == (calib.projector_height, calib.projector_width, 3)
    assert img.dtype == np.uint8
    # colorized depth frame must contain defined (non-white) pixels
    defined = (img != 255).any(axis=-1)
    assert defined.mean() > 0.1


def test_trigger_finder_drop_frame(raw_file):
    """A mid-stream drop_frame request discards a frame's worth of events,
    so one fewer frame is emitted and later frames stay intact (the
    watchdog's lag recovery, reference trigger_finder.py:117-129)."""
    path, depths, events = raw_file
    delta_t = 1e6 / FPS / 4

    def run(drop_after):
        frames = []
        tf = RobustTriggerFinder(
            projector_fps=FPS,
            stats=StatsPrinter(silent=True),
            frame_callback=lambda evs: frames.append(evs.copy()),
        )
        dropped = False
        for packet in FileEventsIterator(path, delta_t=delta_t):
            if not dropped and drop_after is not None and len(frames) >= drop_after:
                tf.drop_frame()
                dropped = True
            tf.process_events(packet)
        return frames

    baseline = run(None)
    with_drop = run(1)  # request the drop after the first emitted frame
    assert len(with_drop) == len(baseline) - 1
    # dropping must not corrupt the frames around the gap
    for f in with_drop:
        assert len(f) > 1000
        span = f["t"][-1] - f["t"][0]
        assert 1e6 / FPS / 2 < span <= 1e6 / FPS


def test_processor_reset_supports_loop_replay(raw_file, calib):
    """reset() lets the same processor replay the stream again
    (--loop-input, reference depth_reprojection.py:72-78)."""
    path, depths, events = raw_file
    proc, shown = _make_processor(calib)
    delta_t = 1e6 / FPS / 4

    for packet in FileEventsIterator(path, delta_t=delta_t):
        proc.process_events(packet)
    proc._pipe.flush()
    first_pass = len(shown)

    proc.reset()
    for packet in FileEventsIterator(path, delta_t=delta_t):
        proc.process_events(packet)
    proc._pipe.flush()

    assert first_pass >= 1
    assert len(shown) == 2 * first_pass
    np.testing.assert_array_equal(shown[0], shown[first_pass])


def test_trigger_finder_reports_global_indices(raw_file):
    """The indexed callback's global start must address the exact slice of
    the cumulative post-filter stream, across push-backs, discards and the
    tail-keep path."""
    path, depths, events = raw_file
    stream_parts, frames = [], []
    tf = RobustTriggerFinder(
        projector_fps=FPS,
        stats=StatsPrinter(silent=True),
        frame_callback=lambda evs: None,
        frame_callback_indexed=lambda evs, gs: frames.append(
            (gs, evs.copy())
        ),
    )
    for packet in FileEventsIterator(path, delta_t=1e6 / FPS / 4):
        stream_parts.append(packet.copy())
        tf.process_events(packet)

    stream = np.concatenate(stream_parts)
    assert len(frames) >= len(depths) - 2
    for gs, f in frames:
        np.testing.assert_array_equal(stream[gs : gs + len(f)], f)


def test_ring_prestage_matches_segmented(raw_file, calib):
    """Packet-ring pre-staged frames must be identical to segmented-staging
    frames, and the ring path must actually be used (no fallbacks)."""
    path, depths, events = raw_file

    def run(prestage):
        proc, shown = _make_processor(calib, prestage=prestage)
        for packet in FileEventsIterator(path, delta_t=1e6 / FPS / 4):
            proc.process_events(packet)
        proc._pipe.flush()
        return proc, shown

    proc_ring, shown_ring = run(True)
    proc_seg, shown_seg = run(False)

    assert proc_ring._pipe.ring is not None
    assert proc_ring._pipe.ring.packets_staged > 0
    assert proc_ring._pipe.ring.overruns == 0
    counters = proc_ring.stats_printer._global.counters
    assert counters.get("ring fallback", 0) == 0
    assert counters.get("frames dispatched", 0) == len(shown_ring)
    assert len(shown_ring) == len(shown_seg) >= len(depths) - 2
    for a, b in zip(shown_ring, shown_seg):
        np.testing.assert_array_equal(a, b)


def test_frame_wanted_gates_display_fetch(raw_file, calib):
    """A sink that wants every 2nd frame must receive exactly those
    frames; skipped frames are still computed (stats counter) but their
    image is never fetched."""
    path, depths, events = raw_file
    proc, shown = _make_processor(calib)
    wanted_calls = []

    def every_other():
        i = len(wanted_calls)
        wanted_calls.append(i)
        return i % 2 == 0

    proc._pipe.frame_wanted = every_other
    for packet in FileEventsIterator(path, delta_t=1e6 / FPS / 4):
        proc.process_events(packet)
    proc._pipe.flush()

    assert len(wanted_calls) >= len(depths) - 2
    assert len(shown) == (len(wanted_calls) + 1) // 2
    skipped = proc.stats_printer._global.counters[
        "frames computed (display skipped)"
    ]
    assert skipped == len(wanted_calls) - len(shown)


def test_prestage_skipped_while_behind(raw_file, calib):
    """While the watchdog is dropping frames, packet bytes must not be
    pre-staged (the ring numbering advances without staging); once caught
    up, staging resumes and frames still come out."""
    path, depths, events = raw_file
    proc, shown = _make_processor(calib)
    proc.params.no_frame_dropping = False
    # force "behind" for the first half of the stream
    behind_calls = {"n": 0}
    wd = proc._pipe.watchdog
    orig = wd.is_processing_behind

    def fake_behind(evs):
        orig(evs)  # keep internal state ticking
        behind_calls["n"] += 1
        return behind_calls["n"] <= 10
    wd.is_processing_behind = fake_behind

    staged_before = proc._pipe.ring.packets_staged
    for packet in FileEventsIterator(path, delta_t=1e6 / FPS / 4):
        proc.process_events(packet)
    proc._pipe.flush()

    ring = proc._pipe.ring
    # behind packets were skipped, not staged
    assert ring.packets_staged - staged_before < behind_calls["n"]
    # the global numbering stayed consistent: later frames still decode
    assert len(shown) >= 1


def test_dryrun_multichip_child_sentinel_raises(monkeypatch):
    """A relaunched dry-run child whose env is STILL not ready must raise
    instead of spawning another subprocess (the inherited-XLA_FLAGS
    recursion hazard): the guard fires before any jax import."""
    import sys

    import pytest

    sys.path.insert(0, "/root/repo")
    try:
        import __graft_entry__ as g
    finally:
        sys.path.pop(0)

    monkeypatch.setenv("_XMAPS_DRYRUN_CHILD", "1")
    # conftest pins 8 virtual devices; ask for more so _env_ready is false
    with pytest.raises(RuntimeError, match="relaunched child"):
        g.dryrun_multichip(64)
