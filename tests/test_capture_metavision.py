"""Metavision HAL adapter against a faked SDK (no hardware/SDK in CI).

The fake reproduces the SDK surface the adapter touches -- DeviceDiscovery
serial handling, I_Geometry, I_LL_Biases, EventsIterator packets with
Metavision's EventCD dtype -- so the adapter's wiring (geometry
orientation, bias programming from a .bias file, dtype conversion, close
semantics, registry integration) is fully exercised.
"""

import sys
import types

import numpy as np
import pytest

from xmaps.io.evt_decoder import EVENT_DTYPE

# Metavision's EventCD layout (x/y u16, p i16, t i64)
MV_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")]
)


class _FakeGeometry:
    def get_width(self):
        return 640

    def get_height(self):
        return 480


class _FakeBiases:
    def __init__(self):
        self.written = {}

    def set(self, name, value):
        self.written[name] = value


class _FakeDevice:
    def __init__(self, serial):
        self.serial = serial
        self.biases = _FakeBiases()

    def get_i_geometry(self):
        return _FakeGeometry()

    def get_i_ll_biases(self):
        return self.biases


def _fake_packets():
    rng = np.random.default_rng(0)
    out = []
    t = 0
    for _ in range(3):
        n = int(rng.integers(50, 200))
        ev = np.zeros(n, MV_DTYPE)
        ev["x"] = rng.integers(0, 640, n)
        ev["y"] = rng.integers(0, 480, n)
        ev["p"] = rng.integers(0, 2, n)
        ev["t"] = t + np.sort(rng.integers(0, 4000, n))
        t += 4000
        out.append(ev)
    return out


@pytest.fixture()
def fake_sdk(monkeypatch):
    packets = _fake_packets()
    opened = {}

    hal = types.ModuleType("metavision_hal")

    class DeviceDiscovery:
        @staticmethod
        def open(serial):
            if serial == "missing":
                return None
            dev = _FakeDevice(serial)
            opened["device"] = dev
            return dev

    hal.DeviceDiscovery = DeviceDiscovery

    core = types.ModuleType("metavision_core")
    event_io = types.ModuleType("metavision_core.event_io")

    class EventsIterator:
        def __init__(self, input_path, delta_t):
            assert input_path is opened["device"]
            opened["delta_t"] = delta_t

        def __iter__(self):
            return iter(packets)

    event_io.EventsIterator = EventsIterator
    core.event_io = event_io

    monkeypatch.setitem(sys.modules, "metavision_hal", hal)
    monkeypatch.setitem(sys.modules, "metavision_core", core)
    monkeypatch.setitem(sys.modules, "metavision_core.event_io", event_io)
    return packets, opened


def test_adapter_end_to_end(fake_sdk, tmp_path):
    packets, opened = fake_sdk
    from xmaps.io.capture_metavision import MetavisionCaptureBackend

    session = MetavisionCaptureBackend().open("serial42")
    assert opened["device"].serial == "serial42"
    assert session.get_size() == (480, 640)  # (height, width) orientation

    session.set_biases({"bias_diff_on": 300, "bias_fo": -10})
    assert opened["device"].biases.written == {
        "bias_diff_on": 300,
        "bias_fo": -10,
    }

    got = list(session.packets(delta_t=4166))
    assert opened["delta_t"] == 4166
    assert len(got) == len(packets)
    for g, ref in zip(got, packets):
        assert g.dtype == EVENT_DTYPE
        for f in ("x", "y", "p", "t"):
            np.testing.assert_array_equal(g[f], ref[f])


def test_adapter_no_camera(fake_sdk):
    from xmaps.io.capture_metavision import MetavisionCaptureBackend

    with pytest.raises(RuntimeError, match="No Prophesee camera"):
        MetavisionCaptureBackend().open("missing")


def test_adapter_close_stops_stream(fake_sdk):
    from xmaps.io.capture_metavision import MetavisionCaptureBackend

    session = MetavisionCaptureBackend().open("")
    it = session.packets(delta_t=1000)
    first = next(it)
    assert len(first)
    session.close()
    assert list(it) == []


def test_registry_integration(fake_sdk, monkeypatch):
    """With the (faked) SDK importable, register_metavision_backend adds
    the backend and open_capture auto-picks it as the sole hardware
    backend, programming biases from the .bias file."""
    import xmaps.io.capture as capture
    from xmaps.io.capture_metavision import register_metavision_backend

    monkeypatch.setattr(
        capture, "_REGISTRY", dict(capture._REGISTRY), raising=True
    )
    assert register_metavision_backend() is True
    assert "metavision" in capture.capture_backends()

    import xmaps.io.biases as biases_mod

    bias_path = "/root/reference/data/nebra_evk3.0/live_cam.bias"
    import os

    if not os.path.exists(bias_path):
        pytest.skip("reference bias file unavailable")
    session = capture.open_capture("", bias_file=bias_path)
    assert isinstance(session.get_size(), tuple)
    expected = biases_mod.load_bias_file(bias_path)
    assert fake_sdk[1]["device"].biases.written == {
        k: int(v) for k, v in expected.items()
    }
