"""Frame dedup filter tests vs reference-semantics NumPy oracles
(reference: frame_event_filter.py:19-128) and activity-noise filter tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from xmaps.io.evt_decoder import EVENT_DTYPE
from xmaps.io.filters import ActivityNoiseFilter, polarity_filter
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.filters import apply_frame_filter

W, H = 64, 48
RECT_W = 176


def _events(rng, n=3000):
    ev = np.zeros(n, dtype=EVENT_DTYPE)
    ev["x"] = rng.integers(0, W, n)
    ev["y"] = rng.integers(0, H, n)
    ev["p"] = rng.integers(0, 2, n)
    ev["t"] = np.sort(rng.integers(0, 16000, n))
    ev["t"] -= ev["t"][0]  # match EventBatch's rebasing for t comparisons
    return ev


# NOTE: the reference implements "first event wins" with a reversed-array
# fancy-index scatter (frame_event_filter.py:52-53), whose duplicate-index
# winner is undefined in NumPy and differs across versions (NumPy 2.0
# iterates 2-D index assignment in a different order than 1-D).  We encode
# the DOCUMENTED intent with explicit per-pixel loops; the device filters
# implement the same intent deterministically.


def _first_last_maps(events):
    events = events[events["p"] == 1]
    first_t = {}
    last_t = {}
    for e in events:
        k = (int(e["y"]), int(e["x"]))
        if k not in first_t:
            first_t[k] = int(e["t"])
        last_t[k] = int(e["t"])
    return first_t, last_t


def _oracle_last_per_xy(events):
    """reference frame_event_filter.py:19-39 (last event per pixel)"""
    _, last_t = _first_last_maps(events)
    keys = sorted(last_t)
    ys = np.array([k[0] for k in keys])
    xs = np.array([k[1] for k in keys])
    return xs, ys, np.array([last_t[k] for k in keys])


def _oracle_first_per_xy(events):
    """reference frame_event_filter.py:45-64 intent (first event per pixel)"""
    first_t, _ = _first_last_maps(events)
    keys = sorted(first_t)
    ys = np.array([k[0] for k in keys])
    xs = np.array([k[1] for k in keys])
    return xs, ys, np.array([first_t[k] for k in keys])


def _oracle_mean_per_xy(events):
    """reference frame_event_filter.py:102-128 intent"""
    first_t, last_t = _first_last_maps(events)
    keys = sorted(first_t)
    ys = np.array([k[0] for k in keys])
    xs = np.array([k[1] for k in keys])
    return xs, ys, np.array([(first_t[k] + last_t[k]) // 2 for k in keys])


def _filtered_set(batch, priority=None):
    valid = np.asarray(batch.valid)
    return (
        np.asarray(batch.x)[valid],
        np.asarray(batch.y)[valid],
        np.asarray(batch.t)[valid],
    )


@pytest.mark.parametrize(
    "name,oracle",
    [
        ("last_per_xy", _oracle_last_per_xy),
        ("first_per_xy", _oracle_first_per_xy),
        ("mean_first_last_per_xy", _oracle_mean_per_xy),
    ],
)
def test_dedup_filters_match_oracle(rng, name, oracle):
    ev = _events(rng)
    batch = EventBatch.from_structured(ev, 4096)
    xr = jnp.zeros(4096, jnp.int32)  # unused by xy filters
    fb = apply_frame_filter(
        batch, xr, name=name, camera_width=W, camera_height=H, rect_width=RECT_W
    )
    xs_d, ys_d, ts_d = _filtered_set(fb.batch)
    xs_o, ys_o, ts_o = oracle(ev)
    # compare as (y, x, t) sets (oracle emits raster order, ours keeps lanes)
    k_d = np.sort(ys_d.astype(np.int64) * W * 100000 + xs_d * 100000 + ts_d)
    k_o = np.sort(ys_o.astype(np.int64) * W * 100000 + xs_o * 100000 + ts_o)
    np.testing.assert_array_equal(k_d, k_o)


def test_first_per_yt_matches_oracle(rng):
    ev = _events(rng)
    xr = rng.integers(0, RECT_W, len(ev)).astype(np.int32)
    batch = EventBatch.from_structured(ev, 4096)
    xr_pad = np.zeros(4096, np.int32)
    xr_pad[: len(ev)] = xr
    fb = apply_frame_filter(
        batch,
        jnp.asarray(xr_pad),
        name="first_per_yt",
        camera_width=W,
        camera_height=H,
        rect_width=RECT_W,
    )
    # oracle (frame_event_filter.py:70-99 intent): key (raw y, xp), first
    # event per key wins, carrying its original x and t
    pos = ev["p"] == 1
    evp, xrp = ev[pos], xr[pos]
    firsts = {}
    for e, xr_v in zip(evp, xrp):
        k = (int(e["y"]), int(xr_v))
        if k not in firsts:
            firsts[k] = (int(e["x"]), int(e["t"]))

    xs_d, ys_d, ts_d = _filtered_set(fb.batch)
    assert len(xs_d) == len(firsts)
    k_d = np.sort(ys_d.astype(np.int64) * 10**10 + xs_d * 10**5 + ts_d)
    k_o = np.sort(
        np.array(
            [y * 10**10 + v[0] * 10**5 + v[1] for (y, _), v in firsts.items()],
            dtype=np.int64,
        )
    )
    np.testing.assert_array_equal(k_d, k_o)


def test_polarity_filter(rng):
    ev = _events(rng)
    out = polarity_filter(ev)
    assert (out["p"] == 1).all()
    assert len(out) == (ev["p"] == 1).sum()


def test_activity_filter_keeps_dense_drops_isolated():
    # a dense cluster firing repeatedly + isolated far-away single events
    n_cluster, n_noise = 400, 50
    rng = np.random.default_rng(0)
    ev = np.zeros(n_cluster + n_noise, dtype=EVENT_DTYPE)
    # cluster: 3x3 pixels around (10, 10), dense in time
    ev["x"][:n_cluster] = rng.integers(9, 12, n_cluster)
    ev["y"][:n_cluster] = rng.integers(9, 12, n_cluster)
    # noise: unique isolated pixels
    ev["x"][n_cluster:] = 40 + 2 * np.arange(n_noise) % 24
    ev["y"][n_cluster:] = 40 + 2 * (np.arange(n_noise) // 12)
    ev["p"] = 1
    ev["t"] = np.sort(rng.integers(0, 50000, len(ev)))
    order = np.argsort(ev["t"], kind="stable")
    ev = ev[order]

    filt = ActivityNoiseFilter(W, H, window_us=10000)
    out = filt.process(ev)
    # isolated pixels (x >= 40) mostly removed, cluster mostly kept
    kept_noise = (out["x"] >= 40).sum()
    kept_cluster = (out["x"] < 40).sum()
    assert kept_cluster > n_cluster * 0.9
    assert kept_noise < n_noise * 0.3


def _activity_oracle(packets, width, height, window_us, keep_polarity=1):
    """Sequential pure-Python transcription of the native filter
    (csrc/evt_decoder.cpp act_filter_apply): per event, max last-timestamp
    over the 8 neighbors decides keep; the center pixel updates after."""
    none = np.iinfo(np.int64).min // 2
    last = np.full((height + 2, width + 2), none, np.int64)
    outs = []
    for evs in packets:
        keep = []
        for ev in evs:
            if keep_polarity >= 0 and ev["p"] != keep_polarity:
                continue
            x, y, t = int(ev["x"]) + 1, int(ev["y"]) + 1, int(ev["t"])
            best = max(
                last[y + dy, x + dx]
                for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)
                if (dx, dy) != (0, 0)
            )
            last[y, x] = t
            if t - best <= window_us:
                keep.append(ev)
        outs.append(
            np.array(keep, dtype=EVENT_DTYPE)
            if keep
            else np.zeros(0, dtype=EVENT_DTYPE)
        )
    return outs


def _correlated_packets(rng, n_packets=5, n_per=800):
    """Time-ordered packets with heavy within-packet 3x3 correlation."""
    packets = []
    t0 = 0
    for _ in range(n_packets):
        ev = np.zeros(n_per, dtype=EVENT_DTYPE)
        # half clustered bursts (strings of nearby pixels close in time),
        # half uniform noise; duplicates and equal timestamps included
        cx = rng.integers(1, W - 1, n_per // 8)
        cy = rng.integers(1, H - 1, n_per // 8)
        ev["x"][: n_per // 2] = np.repeat(cx, 4) + rng.integers(
            -1, 2, n_per // 2
        )
        ev["y"][: n_per // 2] = np.repeat(cy, 4) + rng.integers(
            -1, 2, n_per // 2
        )
        ev["x"][n_per // 2 :] = rng.integers(0, W, n_per - n_per // 2)
        ev["y"][n_per // 2 :] = rng.integers(0, H, n_per - n_per // 2)
        ev["p"] = rng.integers(0, 2, n_per)
        ev["t"] = t0 + np.sort(rng.integers(0, 4000, n_per))
        t0 += 4000
        packets.append(np.sort(ev, order="t", kind="stable"))
    return packets


def test_activity_filter_numpy_matches_sequential_oracle():
    # the vectorized NumPy fallback must reproduce the native filter's
    # sequential semantics exactly, including within-packet unlocks
    rng = np.random.default_rng(3)
    packets = _correlated_packets(rng)
    filt = ActivityNoiseFilter(W, H, window_us=700, force_numpy=True)
    got = [filt.process(p) for p in packets]
    want = _activity_oracle(packets, W, H, 700)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_activity_filter_native_matches_numpy():
    from xmaps.io.evt_decoder import _load_native

    if _load_native() is None:
        pytest.skip("native filter unavailable")
    rng = np.random.default_rng(4)
    packets = _correlated_packets(rng)
    nat = ActivityNoiseFilter(W, H, window_us=900)
    fb = ActivityNoiseFilter(W, H, window_us=900, force_numpy=True)
    assert nat._handle is not None
    for p in packets:
        np.testing.assert_array_equal(nat.process(p), fb.process(p))


def test_activity_filter_stateful_across_packets():
    filt = ActivityNoiseFilter(W, H, window_us=1000)
    ev1 = np.zeros(1, dtype=EVENT_DTYPE)
    ev1["x"], ev1["y"], ev1["p"], ev1["t"] = 5, 5, 1, 100
    out1 = filt.process(ev1)  # no neighbors yet
    assert len(out1) == 0
    ev2 = np.zeros(1, dtype=EVENT_DTYPE)
    ev2["x"], ev2["y"], ev2["p"], ev2["t"] = 6, 5, 1, 600
    out2 = filt.process(ev2)  # neighbor (5,5) fired 500us ago
    assert len(out2) == 1
