"""Live-capture seam: backend registry, bias plumbing, and the synthetic
backend driving the full runtime in real time (the hardware-less stand-in
for the reference's Metavision HAL path, bias_events_iterator.py:66-90)."""

import numpy as np
import pytest

from xmaps.io.capture import (
    CaptureBackend,
    CaptureSession,
    LiveEventsIterator,
    capture_backends,
    open_capture,
    register_capture_backend,
)
from xmaps.io.evt_decoder import EVENT_DTYPE


class _DummySession(CaptureSession):
    def __init__(self, serial):
        self.serial = serial
        self.biases = None

    def get_size(self):
        return 48, 64

    def set_biases(self, biases):
        self.biases = dict(biases)

    def packets(self, delta_t):
        ev = np.zeros(4, dtype=EVENT_DTYPE)
        ev["t"] = np.arange(4) * int(delta_t)
        yield ev


class _DummyBackend(CaptureBackend):
    name = "dummy-hw"

    def open(self, serial="", **hints):
        return _DummySession(serial)


@pytest.fixture
def dummy_registered():
    import xmaps.io.capture as cap

    saved = dict(cap._REGISTRY)
    register_capture_backend(_DummyBackend())
    yield
    cap._REGISTRY.clear()
    cap._REGISTRY.update(saved)


def test_registry_and_selection(dummy_registered, tmp_path, monkeypatch):
    assert "synthetic" in capture_backends()
    assert "dummy-hw" in capture_backends()

    # explicit name + serial
    s = open_capture("dummy-hw:abc123")
    assert s.serial == "abc123"

    # auto-selection picks the sole hardware backend (never synthetic)
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    assert isinstance(open_capture(""), _DummySession)

    # env var selection
    monkeypatch.setenv("XMAPS_CAPTURE_BACKEND", "dummy-hw:env7")
    assert open_capture("").serial == "env7"

    with pytest.raises(RuntimeError, match="Unknown capture backend"):
        open_capture("nope")


def test_auto_selection_requires_a_hardware_backend(monkeypatch):
    monkeypatch.delenv("XMAPS_CAPTURE_BACKEND", raising=False)
    # only 'synthetic' registered by default -> must be named explicitly
    with pytest.raises(RuntimeError, match="No capture backend selected"):
        open_capture("")


def test_bias_file_is_programmed(dummy_registered, tmp_path):
    bias_path = tmp_path / "cam.bias"
    bias_path.write_text("300 % bias_diff\n221 % bias_diff_off\n")
    s = open_capture("dummy-hw", bias_file=str(bias_path))
    assert s.biases == {"bias_diff": 300, "bias_diff_off": 221}


def test_synthetic_live_stream_segments_into_frames():
    """The synthetic backend's wall-clock stream must flow through the
    standard packetize -> trigger-finder path and yield whole frames."""
    from xmaps.runtime.trigger_finder import RobustTriggerFinder
    from xmaps.utils.stats import StatsPrinter

    fps = 60
    session = open_capture(
        "synthetic:5",
        camera_width=64,
        camera_height=48,
        projector_width=90,
        projector_height=160,
        projector_fps=fps,
        depths=[0.5, 0.55, 0.6, 0.65, 0.7],
        events_per_frame=2000,
    )
    assert session.get_size() == (48, 64)

    frames = []
    tf = RobustTriggerFinder(
        projector_fps=fps,
        stats=StatsPrinter(silent=True),
        frame_callback=lambda evs: frames.append(evs.copy()),
    )
    it = LiveEventsIterator(session, delta_t=1e6 / fps / 4)
    import time

    t0 = time.perf_counter()
    for pkt in it:
        if len(pkt):
            tf.process_events(pkt)
    wall = time.perf_counter() - t0

    assert len(frames) >= 3  # interior frames of 5
    for f in frames:
        span = f["t"][-1] - f["t"][0]
        assert 1e6 / fps / 2 < span <= 1e6 / fps
        assert len(f) > 1000
    # real-time pacing: 5 frames at 60 Hz take >= ~66 ms of wall clock
    assert wall >= 0.05
