"""Hand-built EVT2/EVT3 byte streams, computed word by word from the
public Prophesee encoding specs -- NOT produced by this repo's encoder.

The round-trip tests (test_io.py) would pass even if the encoder and
decoder shared a misreading of the format; these vectors pin the decoder
to the spec itself: word layouts, vector base-x advance, stale-TIME_LOW
semantics, time-high rollover mid-stream, and non-CD word skipping.
"""

import struct

import numpy as np
import pytest

from xmaps.io.evt_decoder import (
    EvtDecoder,
    decode_evt2_numpy,
    decode_evt3_numpy,
)


def _evt3_raw(words, w=640, h=480):
    header = f"% format EVT3;height={h};width={w}\n% geometry {w}x{h}\n% end\n"
    return header.encode() + struct.pack(f"<{len(words)}H", *words)


def _evt2_raw(words, w=640, h=480):
    header = f"% format EVT2;height={h};width={w}\n% geometry {w}x{h}\n% end\n"
    return header.encode() + struct.pack(f"<{len(words)}I", *words)


# --- EVT3 ------------------------------------------------------------------

# words assembled from the EVT 3.0 spec:
#   [15:12] type; 0x0 ADDR_Y (y[10:0]), 0x2 ADDR_X (pol bit 11, x[10:0]),
#   0x3 VECT_BASE_X (pol bit 11, x[10:0]), 0x4 VECT_12 (valid[11:0]),
#   0x5 VECT_8 (valid[7:0]), 0x6 TIME_LOW (t[11:0]), 0x8 TIME_HIGH
#   (t[23:12]), 0xA EXT_TRIGGER.  Full t = (high << 12) | low, both
#   "last received".
EVT3_WORDS = [
    (0x8 << 12) | 0x100,           # TIME_HIGH = 0x100
    (0x6 << 12) | 0x07B,           # TIME_LOW  = 0x07B
    (0x0 << 12) | 42,              # y = 42
    (0x2 << 12) | (1 << 11) | 100, # CD x=100 p=1
    (0x3 << 12) | (0 << 11) | 200, # VECT_BASE_X base=200 p=0
    (0x4 << 12) | 0b000000000101,  # VECT_12: bits 0,2 -> x=200,202
    (0x5 << 12) | 0b10000001,      # VECT_8 after base+=12: bits 0,7 -> x=212,219
    (0xA << 12) | 0x001,           # EXT_TRIGGER: must be skipped
    (0x8 << 12) | 0x101,           # TIME_HIGH=0x101; TIME_LOW 0x7B persists
    (0x2 << 12) | (0 << 11) | 5,   # CD x=5 p=0 at t=(0x101<<12)|0x7B
    (0x6 << 12) | 0xFFF,           # TIME_LOW = 0xFFF
    (0x2 << 12) | (0 << 11) | 6,   # CD x=6 at t=(0x101<<12)|0xFFF
]

T0 = (0x100 << 12) | 0x07B
EVT3_EXPECT = [
    # (x, y, p, t)
    (100, 42, 1, T0),
    (200, 42, 0, T0),
    (202, 42, 0, T0),
    (212, 42, 0, T0),
    (219, 42, 0, T0),
    (5, 42, 0, (0x101 << 12) | 0x07B),
    (6, 42, 0, (0x101 << 12) | 0xFFF),
]


def _check(decoded, expect):
    assert len(decoded) == len(expect), (len(decoded), len(expect))
    for i, (x, y, p, t) in enumerate(expect):
        got = decoded[i]
        assert (got["x"], got["y"], got["p"], got["t"]) == (x, y, p, t), (
            f"event {i}: got {tuple(got)} want {(x, y, p, t)}"
        )


def test_evt3_spec_vector_native(tmp_path):
    path = str(tmp_path / "spec.raw")
    with open(path, "wb") as f:
        f.write(_evt3_raw(EVT3_WORDS))
    dec = EvtDecoder(path)
    assert dec._native is not None, "native decoder must be active"
    assert (dec.width, dec.height) == (640, 480)
    out = np.concatenate(list(dec))
    dec.close()
    _check(out, EVT3_EXPECT)


def test_evt3_spec_vector_numpy():
    words = np.array(EVT3_WORDS, dtype="<u2")
    _check(decode_evt3_numpy(words), EVT3_EXPECT)


def test_evt3_time_high_rollover_mid_stream(tmp_path):
    """The 12-bit TIME_HIGH wraps; decoded timestamps must keep rising."""
    words = [
        (0x8 << 12) | 0xFFF,
        (0x6 << 12) | 0x001,
        (0x0 << 12) | 7,
        (0x2 << 12) | 10,            # t = (0xFFF << 12) | 1
        (0x8 << 12) | 0x000,         # rollover
        (0x2 << 12) | 11,            # t = (0x1000 << 12) | 1 (stale low)
        (0x6 << 12) | 0x002,
        (0x2 << 12) | 12,            # t = (0x1000 << 12) | 2
    ]
    expect = [
        (10, 7, 0, (0xFFF << 12) | 1),
        (11, 7, 0, (0x1000 << 12) | 1),
        (12, 7, 0, (0x1000 << 12) | 2),
    ]
    path = str(tmp_path / "roll.raw")
    with open(path, "wb") as f:
        f.write(_evt3_raw(words))
    out = np.concatenate(list(EvtDecoder(path)))
    _check(out, expect)
    _check(decode_evt3_numpy(np.array(words, dtype="<u2")), expect)
    assert np.all(np.diff(out["t"]) >= 0)


def test_evt3_events_before_time_base_dropped(tmp_path):
    """CD words arriving before the first TIME_HIGH have no timebase and
    must be discarded, not emitted with a junk timestamp."""
    words = [
        (0x0 << 12) | 3,
        (0x2 << 12) | 9,              # no timebase yet: dropped
        (0x8 << 12) | 0x001,
        (0x6 << 12) | 0x005,
        (0x2 << 12) | 9,              # first valid event
    ]
    expect = [(9, 3, 0, (1 << 12) | 5)]
    path = str(tmp_path / "pre.raw")
    with open(path, "wb") as f:
        f.write(_evt3_raw(words))
    _check(np.concatenate(list(EvtDecoder(path))), expect)
    _check(decode_evt3_numpy(np.array(words, dtype="<u2")), expect)


# --- EVT2 ------------------------------------------------------------------

# EVT 2.0 spec: 32-bit words, [31:28] type (0x0 CD_OFF, 0x1 CD_ON,
# 0x8 TIME_HIGH, 0xA EXT_TRIGGER, 0xE OTHERS, 0xF CONTINUED);
# CD: [27:22] t[5:0], [21:11] x, [10:0] y; TIME_HIGH: [27:0] = t >> 6.
EVT2_WORDS = [
    (0x8 << 28) | 0x0000001,                      # TIME_HIGH = 1
    (0x1 << 28) | (5 << 22) | (10 << 11) | 20,    # ON  x=10 y=20 t=(1<<6)|5
    (0xA << 28) | 77,                             # EXT_TRIGGER: skipped
    (0x0 << 28) | (63 << 22) | (11 << 11) | 21,   # OFF x=11 y=21 t=(1<<6)|63
    (0xE << 28) | 1,                              # OTHERS: skipped
    (0xF << 28) | 2,                              # CONTINUED: skipped
    (0x8 << 28) | 0x0000002,
    (0x1 << 28) | (0 << 22) | (12 << 11) | 22,    # t = 2<<6
]

EVT2_EXPECT = [
    (10, 20, 1, (1 << 6) | 5),
    (11, 21, 0, (1 << 6) | 63),
    (12, 22, 1, 2 << 6),
]


def test_evt2_spec_vector_native(tmp_path):
    path = str(tmp_path / "spec2.raw")
    with open(path, "wb") as f:
        f.write(_evt2_raw(EVT2_WORDS))
    dec = EvtDecoder(path)
    assert dec._native is not None
    _check(np.concatenate(list(dec)), EVT2_EXPECT)
    dec.close()


def test_evt2_spec_vector_numpy():
    _check(decode_evt2_numpy(np.array(EVT2_WORDS, dtype="<u4")), EVT2_EXPECT)


def test_evt2_time_high_rollover(tmp_path):
    words = [
        (0x8 << 28) | 0xFFFFFFF,
        (0x1 << 28) | (1 << 22) | (1 << 11) | 1,
        (0x8 << 28) | 0x0000000,                   # 28-bit rollover
        (0x1 << 28) | (2 << 22) | (2 << 11) | 2,
    ]
    expect = [
        (1, 1, 1, (0xFFFFFFF << 6) | 1),
        (2, 2, 1, (0x10000000 << 6) | 2),
    ]
    path = str(tmp_path / "roll2.raw")
    with open(path, "wb") as f:
        f.write(_evt2_raw(words))
    out = np.concatenate(list(EvtDecoder(path)))
    _check(out, expect)
    _check(decode_evt2_numpy(np.array(words, dtype="<u4")), expect)
    assert np.all(np.diff(out["t"]) > 0)


def test_header_dialects(tmp_path):
    """'% evt 3.0' / '% evt 2.0' header lines (older tooling) must select
    the right payload decoder."""
    payload3 = struct.pack(
        "<4H",
        (0x8 << 12) | 1, (0x6 << 12) | 2, (0x0 << 12) | 3, (0x2 << 12) | 4,
    )
    raw3 = b"% evt 3.0\n% geometry 640x480\n% end\n" + payload3
    p3 = str(tmp_path / "d3.raw")
    with open(p3, "wb") as f:
        f.write(raw3)
    out = np.concatenate(list(EvtDecoder(p3)))
    assert len(out) == 1 and out[0]["t"] == (1 << 12) | 2

    payload2 = struct.pack(
        "<2I", (0x8 << 28) | 1, (0x1 << 28) | (3 << 22) | (4 << 11) | 5
    )
    raw2 = b"% evt 2.0\n% geometry 640x480\n% end\n" + payload2
    p2 = str(tmp_path / "d2.raw")
    with open(p2, "wb") as f:
        f.write(raw2)
    out = np.concatenate(list(EvtDecoder(p2)))
    assert len(out) == 1 and out[0]["t"] == (1 << 6) | 3


def test_native_lib_path_tracks_source_hash(monkeypatch, tmp_path):
    """The committed prebuilt .so can never shadow stale source: the load
    path embeds sha256(evt_decoder.cpp), so (a) the in-tree artifact's
    name must match the CURRENT source hash, and (b) any source change
    resolves to a different path (forcing a rebuild or NumPy fallback)."""
    import hashlib
    import os

    from xmaps.io import evt_decoder as mod

    src = mod._CSRC
    assert os.path.exists(src)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = mod._lib_path()
    assert path is not None and path.endswith(f"libevt_decoder-{digest}.so")
    committed = [
        n for n in os.listdir(os.path.dirname(path)) if n.endswith(".so")
    ]
    assert committed == [os.path.basename(path)], (
        "in-tree prebuilt .so does not match the current csrc hash -- "
        "rebuild and recommit (make -C csrc) or delete it"
    )

    # a one-byte source change must resolve to a DIFFERENT artifact path
    altered = tmp_path / "evt_decoder.cpp"
    with open(src, "rb") as f:
        altered.write_bytes(f.read() + b"\n// touched\n")
    monkeypatch.setattr(mod, "_CSRC", str(altered))
    assert mod._lib_path() != path
