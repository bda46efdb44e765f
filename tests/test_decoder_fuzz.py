"""Differential fuzzing of the native C++ decoder against the NumPy
reference decoders.

The spec-vector tests pin both implementations to hand-computed words;
this file pins them to EACH OTHER on inputs neither was written for:
random word soups, bit-flipped valid streams, and vector-heavy streams
decoded through adversarially small chunk sizes (exercising the
mid-vector capacity rewind at every chunk boundary).  Any divergence or
crash is a real bug in one of the two.

Skipped when the native library is unavailable (NumPy-only hosts run
the spec-vector tests instead).
"""

import struct

import numpy as np
import pytest

from xmaps.io.evt_decoder import (
    EVENT_DTYPE,
    EvtDecoder,
    _load_native,
    decode_evt2_numpy,
    decode_evt3_numpy,
)

pytestmark = pytest.mark.skipif(
    _load_native() is None, reason="native decoder unavailable"
)


def _evt3_raw(words, w=640, h=480):
    header = f"% format EVT3;height={h};width={w}\n% end\n"
    return header.encode() + struct.pack(f"<{len(words)}H", *words)


def _evt2_raw(words, w=640, h=480):
    header = f"% format EVT2;height={h};width={w}\n% end\n"
    return header.encode() + struct.pack(f"<{len(words)}I", *words)


def _native_decode(tmp_path, raw: bytes, name: str, chunk_events: int):
    p = tmp_path / name
    p.write_bytes(raw)
    dec = EvtDecoder(str(p), chunk_events=chunk_events)
    assert dec._native is not None, "test requires the native decoder"
    chunks = list(dec)
    dec.close()
    if not chunks:
        return np.zeros(0, dtype=EVENT_DTYPE)
    return np.concatenate(chunks)


def _assert_same(native, ref):
    assert len(native) == len(ref), (len(native), len(ref))
    for f in ("x", "y", "p", "t"):
        np.testing.assert_array_equal(native[f], ref[f], err_msg=f)


@pytest.mark.parametrize("seed", range(8))
def test_evt3_random_word_soup(tmp_path, seed):
    """Uniformly random uint16 words: every type nibble appears, including
    undefined ones, vector words with random masks, and wild time jumps."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 16, size=5000, dtype=np.uint16)
    raw = _evt3_raw(words.tolist())
    ref = decode_evt3_numpy(words.astype("<u2"))
    native = _native_decode(tmp_path, raw, f"soup_{seed}.raw", 1 << 20)
    _assert_same(native, ref)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_evt3_vector_heavy_small_chunks(tmp_path, seed, chunk):
    """Streams dominated by VECT_12/VECT_8 words decoded through tiny
    chunk capacities: every chunk boundary can split a vector word, which
    must be rewound and re-read, never dropped or duplicated."""
    rng = np.random.default_rng(100 + seed)
    words = [(0x8 << 12) | 0x010, (0x6 << 12) | 0x001, (0x0 << 12) | 7]
    for _ in range(400):
        kind = rng.integers(0, 4)
        if kind == 0:
            words.append((0x3 << 12) | int(rng.integers(0, 1 << 12)))
        elif kind == 1:
            words.append((0x4 << 12) | int(rng.integers(0, 1 << 12)))
        elif kind == 2:
            words.append((0x5 << 12) | int(rng.integers(0, 1 << 8)))
        else:
            words.append((0x2 << 12) | int(rng.integers(0, 1 << 12)))
    arr = np.array(words, dtype="<u2")
    ref = decode_evt3_numpy(arr)
    native = _native_decode(
        tmp_path, _evt3_raw(words), f"vect_{seed}_{chunk}.raw", chunk
    )
    _assert_same(native, ref)


@pytest.mark.parametrize("seed", range(8))
def test_evt2_random_word_soup(tmp_path, seed):
    rng = np.random.default_rng(200 + seed)
    words = rng.integers(0, 1 << 32, size=4000, dtype=np.uint32)
    raw = _evt2_raw(words.tolist())
    ref = decode_evt2_numpy(words.astype("<u4"))
    native = _native_decode(tmp_path, raw, f"soup2_{seed}.raw", 1 << 20)
    _assert_same(native, ref)


@pytest.mark.parametrize("seed", range(4))
def test_evt3_bitflipped_synthetic_stream(tmp_path, seed):
    """A valid encoded stream with random bit flips: decoders must agree
    on how corruption is absorbed (skip/misparse identically), not crash."""
    from xmaps.io.evt_encode import encode_evt3
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration(
        camera_width=128, camera_height=96,
        projector_width=96, projector_height=128,
    )
    evs = simulate_plane_events(
        calib, depth_m=0.5, subsample=0.3, rng=np.random.default_rng(seed)
    )
    raw = bytearray(encode_evt3(evs, 128, 96))
    hdr = raw.index(b"% end\n") + len(b"% end\n")
    rng = np.random.default_rng(300 + seed)
    for _ in range(40):
        k = int(rng.integers(hdr, len(raw)))
        raw[k] ^= 1 << int(rng.integers(0, 8))
    payload = bytes(raw[hdr:])
    words = np.frombuffer(payload[: len(payload) // 2 * 2], dtype="<u2")
    ref = decode_evt3_numpy(words)
    native = _native_decode(tmp_path, bytes(raw), f"flip_{seed}.raw", 777)
    _assert_same(native, ref)


@pytest.mark.parametrize("seed", range(4))
def test_dat_random_records(tmp_path, seed):
    """Random DAT record pairs decode identically in both implementations."""
    from xmaps.io.evt_decoder import decode_dat_numpy

    rng = np.random.default_rng(400 + seed)
    words = rng.integers(0, 1 << 32, size=2000, dtype=np.uint32)
    header = b"% Data file containing CD events\n% Version 2\n% end\n"
    raw = header + bytes([0x0C, 0x08]) + words.tobytes()
    ref = decode_dat_numpy(words.astype("<u4"))
    p = tmp_path / f"r{seed}.dat"
    p.write_bytes(raw)
    dec = EvtDecoder(str(p), chunk_events=333)
    native_used = dec._native is not None
    chunks = list(dec)
    dec.close()
    native = np.concatenate(chunks) if chunks else ref[:0]
    _assert_same(native, ref)
    assert native_used


@pytest.mark.parametrize(
    "blob",
    [
        b"",                                   # empty file
        b"% format EVT3\n",                    # header, no end marker, no data
        b"%" * 1000,                           # comment soup
        b"\x00\x01\x02\x03" * 7,               # headerless binary, odd length
        b"% format EVT3;width=640\n% end\n\xff",  # truncated word
    ],
)
def test_malformed_files_do_not_crash(tmp_path, blob):
    """Garbage inputs must yield an event stream (possibly empty), never
    a crash, from whichever decoder handles them."""
    p = tmp_path / "junk.raw"
    p.write_bytes(blob)
    dec = EvtDecoder(str(p), chunk_events=64)
    chunks = list(dec)
    dec.close()
    total = sum(len(c) for c in chunks)
    assert total >= 0  # reachable = no crash
