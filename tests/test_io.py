"""Event IO tests: RAW encode/decode round trips, native vs NumPy parity."""

import os

import numpy as np
import pytest

from xmaps.io.evt_decoder import (
    EVENT_DTYPE,
    EvtDecoder,
    decode_evt2_numpy,
    decode_evt3_numpy,
    decode_file,
    parse_raw_header,
    _load_native,
)
from xmaps.io.evt_encode import encode_dat, encode_evt2, encode_evt3
from xmaps.io.event_iterator import FileEventsIterator


def _random_events(rng, n=5000, w=640, h=480, t_span=100_000):
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, w, n)
    ev["y"] = rng.integers(0, h, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = np.sort(rng.integers(0, t_span, n))
    return ev


@pytest.fixture(scope="module")
def events(rng=np.random.default_rng(3)):
    return _random_events(np.random.default_rng(3))


@pytest.mark.parametrize("fmt", ["evt2", "evt3", "dat"])
def test_roundtrip_native(tmp_path, events, fmt):
    enc = {"evt2": encode_evt2, "evt3": encode_evt3, "dat": encode_dat}[fmt]
    path = str(tmp_path / f"test_{fmt}.{'dat' if fmt == 'dat' else 'raw'}")
    with open(path, "wb") as f:
        f.write(enc(events, 640, 480))

    decoded = decode_file(path)
    assert len(decoded) == len(events)
    np.testing.assert_array_equal(decoded["x"], events["x"])
    np.testing.assert_array_equal(decoded["y"], events["y"])
    np.testing.assert_array_equal(decoded["t"], events["t"])
    if fmt != "dat":
        np.testing.assert_array_equal(decoded["p"], events["p"] & 1)


def test_native_available():
    assert _load_native() is not None, "native decoder failed to build"


def test_numpy_decoder_matches_native(tmp_path, events):
    raw = encode_evt2(events, 640, 480)
    hdr_len, fmt, geom = parse_raw_header(raw)
    assert fmt == "EVT2" and geom == (640, 480)
    words = np.frombuffer(raw[hdr_len:], dtype="<u4")
    dec_np = decode_evt2_numpy(words)
    np.testing.assert_array_equal(dec_np["t"], events["t"])
    np.testing.assert_array_equal(dec_np["x"], events["x"])

    raw3 = encode_evt3(events, 640, 480)
    hdr_len3, fmt3, _ = parse_raw_header(raw3)
    assert fmt3 == "EVT3"
    words3 = np.frombuffer(raw3[hdr_len3:], dtype="<u2")
    dec3 = decode_evt3_numpy(words3)
    # EVT3 vectorization may reorder events within one (t, y) group; compare
    # as multisets per timestamp
    assert len(dec3) == len(events)
    np.testing.assert_array_equal(np.sort(dec3["t"]), np.sort(events["t"]))
    k1 = dec3["t"].astype(np.int64) * 2**22 + dec3["y"] * 2**11 + dec3["x"]
    k2 = events["t"].astype(np.int64) * 2**22 + events["y"] * 2**11 + events["x"]
    np.testing.assert_array_equal(np.sort(k1), np.sort(k2))


def test_evt2_time_high_rollover():
    """Timestamps must extend past the 28+6 bit rollover of EVT2."""
    n = 10
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = np.arange(n)
    ev["y"] = 1
    ev["p"] = 1
    base = (1 << 34) - 5 * 64  # near the 28-bit TIME_HIGH rollover
    ev["t"] = base + np.arange(n) * 64
    raw = encode_evt2(ev, 640, 480)
    hdr_len, _, _ = parse_raw_header(raw)
    dec = decode_evt2_numpy(np.frombuffer(raw[hdr_len:], dtype="<u4"))
    np.testing.assert_array_equal(dec["t"], ev["t"])


def test_evt3_chunk_boundaries_lose_no_events(tmp_path, events):
    """Chunked native decode == one-shot decode for every chunk size.

    Regression test for the mid-vector capacity bug: when evt_decode's
    output buffer fills inside a VECT_12/VECT_8 word, the word must be
    re-issued on the next call instead of dropping its remaining bits.
    Odd chunk sizes force the boundary to land mid-vector."""
    # dense same-(t, y) runs of consecutive x -> guaranteed VECT_12 words
    n = 4096
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = np.tile(np.arange(64), n // 64) + 37
    ev["y"] = np.repeat(np.arange(n // 64), 64) % 480
    ev["p"] = 1
    ev["t"] = np.repeat(np.arange(n // 64), 64) * 11

    path = str(tmp_path / "chunks.raw")
    with open(path, "wb") as f:
        f.write(encode_evt3(ev, 640, 480))
    want = decode_file(path)
    assert len(want) == n

    for chunk in (13, 100, 4097):
        dec = EvtDecoder(path, chunk_events=chunk)
        got = np.concatenate(list(dec) or [np.zeros(0, dtype=EVENT_DTYPE)])
        dec.close()
        np.testing.assert_array_equal(got, want)


def test_iterator_packets(tmp_path, events):
    path = str(tmp_path / "pkt.raw")
    with open(path, "wb") as f:
        f.write(encode_evt2(events, 640, 480))
    it = FileEventsIterator(path, delta_t=10_000)
    assert it.get_size() == (480, 640)
    packets = list(it)
    total = np.concatenate(packets)
    np.testing.assert_array_equal(total["t"], events["t"])
    # each packet spans <= delta_t
    for p in packets[:-1]:
        if len(p) > 1:
            assert p["t"][-1] - p["t"][0] <= 10_000


def test_npy_passthrough(tmp_path, events):
    path = str(tmp_path / "events.npy")
    np.save(path, events)
    dec = decode_file(path)
    np.testing.assert_array_equal(dec["t"], events["t"])
