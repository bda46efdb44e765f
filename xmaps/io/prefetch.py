"""Double-buffered host->device staging of event batches.

The reference recycles native event buffers through a free list
(event_buf_pool.py:10-17) so the per-packet hot path never allocates.
The device equivalent staged here:

- ``HostStagingPool`` owns ``depth`` preallocated packed host buffers at
  the pipeline's fixed capacity and fills them in place per frame -- no
  host allocation per frame;
- events cross the host->device link as TWO words per event instead of
  five arrays: ``xy = x | y << 16`` (uint32) and ``tp = t | p << 30``
  (int32, frame-relative microseconds fit 24 bits).  The validity mask
  is implied by the event count (lanes [0, n) are valid), so it is never
  transferred (256 KB/frame instead of 640 KB at 64k capacity);
- each ``stage`` call issues one async ``jax.device_put``, so the H2D
  copy of frame N+1 overlaps the device compute of frame N (the pipe
  keeps one frame in flight, runtime/pipe.py);
- the slots rotate, and a slot is only rewritten after the frame that
  consumed it has been fetched back (the pipe flushes frame N's result
  before staging frame N+2), so the async transfer is never raced.

Buffer donation was evaluated and removed: the frame program's outputs
(projector-resolution images + a scalar) share no shape/dtype with the
event arrays, so XLA cannot alias them (it warns "donated buffers were
not usable") -- device-side memory reuse comes from XLA's allocator freeing
the previous frame's buffers, which this pool's fixed-shape staging
makes trivially recyclable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from xmaps.ops.event_batch import EventBatch

__all__ = [
    "HostStagingPool",
    "StagedBatch",
    "unpack_staged",
    "CompactLayout",
    "CompactStagedBatch",
    "unpack_staged_compact",
    "PacketRing",
    "RingPacket",
    "RingLayout",
    "RING_SLOTS_PER_FRAME",
    "assemble_ring_frame",
    "assemble_ring_frame_compact",
]

#: polarity rides in bit 30 of the int32 tp word; frame-relative
#: microsecond timestamps are far below 2**30 (~17.9 min).
_P_SHIFT = 30
_T_MASK = (1 << _P_SHIFT) - 1


class StagedBatch(NamedTuple):
    """One staged frame: packed device arrays + count."""

    xy: jax.Array  # (capacity,) uint32: x | y << 16
    tp: jax.Array  # (capacity,) int32: t_rel | p << 30
    count: jax.Array  # int32 scalar


def unpack_staged(staged: StagedBatch) -> EventBatch:
    """Trace-time unpack to the standard EventBatch (fuses into the
    consumer program; nothing extra touches device memory)."""
    n = staged.xy.shape[0]
    xy = staged.xy.astype(jnp.int32)
    x = xy & 0xFFFF
    y = (xy >> 16) & 0xFFFF
    t = staged.tp & _T_MASK
    p = staged.tp >> _P_SHIFT
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
    valid = lane < staged.count
    return EventBatch(x=x, y=y, t=t, p=p, valid=valid, count=staged.count)


class CompactLayout(NamedTuple):
    """Bit layout for ONE-word-per-event staging.

    The X-map lookup only ever sees the event's time as a discretized
    bin in [0, t_px_scale] (time axis = projector columns,
    ops/disparity.py), so the host can compute the bin exactly -- the
    same integer round-half-to-even as the device -- and ship
    ``t_scaled`` instead of a raw timestamp.  With the coordinates that
    fits one uint32 per event (word = x | y << bits_x | t_scaled <<
    (bits_x + bits_y)), halving host->device bytes vs the 2-word
    staging.  Polarity is not carried: the host polarity filter runs
    before staging, and nothing on device reads p (the frame dedup
    filters, the only consumers, force the 2-word path -- they must
    re-bin time after dropping events).
    """

    bits_x: int
    bits_y: int
    bits_t: int
    t_px_scale: int

    @staticmethod
    def for_pipeline(cfg) -> Optional["CompactLayout"]:
        """Layout for a PipelineConfig, or None if 32 bits don't fit
        (very large sensor / time axis) -- callers fall back to 2-word
        staging."""
        bits_x = max(int(cfg.camera_width - 1).bit_length(), 1)
        bits_y = max(int(cfg.camera_height - 1).bit_length(), 1)
        bits_t = max(int(cfg.t_px_scale).bit_length(), 1)
        if bits_x + bits_y + bits_t > 32:
            return None
        return CompactLayout(bits_x, bits_y, bits_t, int(cfg.t_px_scale))


class CompactStagedBatch(NamedTuple):
    """One staged frame at one uint32 word per event.

    ``presorted`` (host-side flag) is True when the host staged the
    events TARGET-SORTED (HostStagingPool presort_fn): the device scatter
    may then run sort-free (depth_frame presort_* args).
    """

    word: jax.Array  # (capacity,) uint32: x | y << bits_x | ts << (bx+by)
    count: jax.Array  # int32 scalar
    presorted: bool = False


def unpack_staged_compact(
    staged: CompactStagedBatch, layout: CompactLayout
) -> tuple[EventBatch, jax.Array]:
    """Trace-time unpack to (EventBatch, t_scaled).

    The returned batch carries p=1 (host polarity filter ran before
    staging) and t = t_scaled (only the bins exist at this point); pass
    t_scaled explicitly to the frame program so it skips re-binning.
    """
    n = staged.word.shape[0]
    w = staged.word.astype(jnp.int32)
    x = w & ((1 << layout.bits_x) - 1)
    y = (w >> layout.bits_x) & ((1 << layout.bits_y) - 1)
    ts = (w >> (layout.bits_x + layout.bits_y)) & ((1 << layout.bits_t) - 1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).reshape(n)
    valid = lane < staged.count
    batch = EventBatch(
        x=x,
        y=y,
        t=ts,
        p=jnp.ones_like(x),
        valid=valid,
        count=staged.count,
    )
    return batch, ts


def _scale_time_int_host(t: np.ndarray, t_px_scale: int) -> np.ndarray:
    """Host mirror of ops.disparity._scale_time_int (exact integer
    round-half-to-even of (t - min) * scale / (max - min)), in int64."""
    t = np.asarray(t, dtype=np.int64)
    if len(t) == 0:
        return t.astype(np.int32)
    t_min = t.min()
    rng = max(int(t.max()) - int(t_min), 1)
    num = (t - t_min) * np.int64(t_px_scale)
    q, r = np.divmod(num, rng)
    twice = 2 * r
    round_up = (twice > rng) | ((twice == rng) & (q % 2 == 1))
    return (q + round_up).astype(np.int32)


class HostStagingPool:
    """Rotating preallocated host buffers for packed EventBatch staging."""

    def __init__(
        self,
        capacity: int,
        depth: int = 2,
        device: Optional[jax.Device] = None,
        layout: Optional[CompactLayout] = None,
        presort_fn=None,
    ):
        """``presort_fn(evs, ts) -> order``: host target-sort for compact
        staging (models.depth_pipeline.XMapsDepthEngine.compact_presort).
        ``order`` permutes the frame's events into scatter-target order
        (stable, so arrival order survives within equal targets and lane
        index works as the last-write-wins priority); the staged batch is
        then marked ``presorted``."""
        assert depth >= 2, "need >= 2 slots to overlap H2D with compute"
        self.capacity = capacity
        self.device = device
        self.layout = layout
        self.presort_fn = presort_fn
        self._slots = [
            {
                "xy": np.zeros(capacity, np.uint32),
                "tp": np.zeros(capacity, np.int32),
                "word": np.zeros(capacity, np.uint32),
            }
            for _ in range(depth)
        ]
        self._next = 0
        self.frames_staged = 0
        self.events_truncated = 0

    def stage(self, evs: np.ndarray) -> StagedBatch:
        """Fill the next host slot in place and start the async H2D copy.

        Semantics match EventBatch.from_structured (rebased int32
        timestamps, zero padding, truncation at capacity).
        """
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)

        cap = self.capacity
        n = min(len(evs), cap)
        if len(evs) > cap:
            self.events_truncated += len(evs) - cap

        xy = slot["xy"]
        np.left_shift(
            evs["y"][:n].astype(np.uint32), 16, out=xy[:n], casting="unsafe"
        )
        np.bitwise_or(
            xy[:n], evs["x"][:n].astype(np.uint32), out=xy[:n]
        )
        xy[n:] = 0

        tp = slot["tp"]
        if n:
            t64 = evs["t"][:n].astype(np.int64, copy=False)
            np.subtract(t64, t64[0], out=tp[:n], casting="unsafe")
            np.bitwise_or(
                tp[:n],
                (evs["p"][:n].astype(np.int32) & 1) << _P_SHIFT,
                out=tp[:n],
            )
        tp[n:] = 0

        self.frames_staged += 1
        xy_d, tp_d, n_d = jax.device_put(
            (xy, tp, np.int32(n)), self.device
        )
        return StagedBatch(xy=xy_d, tp=tp_d, count=n_d)

    def stage_compact(self, evs: np.ndarray) -> CompactStagedBatch:
        """Fill the next host slot at ONE uint32 word per event and start
        the async H2D copy.  Requires a CompactLayout (pool init) and a
        complete frame slice (time bins need the frame's min/max t).
        Bit-identical downstream results to :meth:`stage` for
        frame_filter == "none" pipelines."""
        lay = self.layout
        assert lay is not None, "HostStagingPool built without a layout"
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)

        cap = self.capacity
        n = min(len(evs), cap)
        if len(evs) > cap:
            self.events_truncated += len(evs) - cap

        word = slot["word"]
        if n:
            ts = _scale_time_int_host(evs["t"][:n], lay.t_px_scale)
            xs = evs["x"][:n]
            ys = evs["y"][:n]
            if self.presort_fn is not None:
                order = self.presort_fn(evs[:n], ts)
                xs, ys, ts = xs[order], ys[order], ts[order]
            np.left_shift(
                ts.astype(np.uint32),
                lay.bits_x + lay.bits_y,
                out=word[:n],
                casting="unsafe",
            )
            np.bitwise_or(
                word[:n],
                ys.astype(np.uint32) << lay.bits_x,
                out=word[:n],
            )
            np.bitwise_or(
                word[:n], xs.astype(np.uint32), out=word[:n]
            )
        word[n:] = 0

        self.frames_staged += 1
        w_d, n_d = jax.device_put((word, np.int32(n)), self.device)
        return CompactStagedBatch(
            word=w_d, count=n_d, presorted=self.presort_fn is not None
        )


# ---------------------------------------------------------------------------
# Packet-ring pre-staging: move the bytes while the frame is still arriving
# ---------------------------------------------------------------------------
#
# The staging above ships a frame's events AFTER the trigger finder has
# segmented it, so the H2D copy sits on the critical path of the frame's
# latency.  But the events exist long before the trigger fires: packets
# arrive 4x per frame (delta_t = T/4, apps/depth_reprojection.py).  The
# PacketRing stages every filtered packet to the device the moment it
# arrives; when the trigger finder later emits a frame as a GLOBAL event
# index range [gs, ge), the frame program assembles it on device from the
# already-resident packet slots -- the only dispatch-time transfer is a
# (3, K) int32 metadata array.  Per-event data crosses the link exactly
# once, during frame accumulation, off the latency path.

#: max packets assembled into one frame (4/frame nominal + trigger slack;
#: packets longer than the slot capacity are split at staging)
RING_SLOTS_PER_FRAME = 8


class RingLayout(NamedTuple):
    """ONE-word-per-event ring staging: ``x | y << bits_x |
    t_rel << (bits_x + bits_y)``.

    Halves the bytes each packet pushes across the host->device link --
    the link is the streaming path's latency floor, so this directly
    lowers end-to-end frame latency.  Valid when (a) the polarity filter
    runs upstream of staging (the pipe's fused polarity+activity filter
    guarantees every staged event has p == 1, so polarity needs no bit)
    and (b) the camera dims leave >= 13 bits for the packet-relative
    time (arrival packets span delta_t ~4.2 ms < 8.2 ms; longer spans
    are split at stage time).  640x480 sensors fit exactly
    (10 + 9 + 13 = 32); larger sensors fall back to 2-word staging."""

    bits_x: int
    bits_y: int
    bits_t: int

    @staticmethod
    def for_camera(width: int, height: int) -> Optional["RingLayout"]:
        bx = max(int(np.ceil(np.log2(max(width, 2)))), 1)
        by = max(int(np.ceil(np.log2(max(height, 2)))), 1)
        bt = 32 - bx - by
        if bt < 13:
            return None
        return RingLayout(bx, by, bt)


class RingPacket(NamedTuple):
    """One staged packet: device arrays + host-side placement metadata."""

    xy: jax.Array  # (packet_capacity,) uint32: x | y << 16, or the
    #   single packed word when the ring uses a RingLayout
    tp: Optional[jax.Array]  # (packet_capacity,) int32: t_rel | p << 30;
    #   None in compact (RingLayout) mode
    gbase: int  # global index of this packet's first event
    count: int  # valid events in the slot
    t_base: int  # absolute microsecond timestamp of the first event
    slot: int  # host slot index (ring bookkeeping)


def _place_segments(tabs: tuple, starts, cum0, capacity: int):
    """Concatenate per-slot segments tabs[k][starts[k]:] at output offsets
    cum0[k], as K shift-copies (dynamic_slice + dynamic_update_slice).

    The obvious per-lane formulation is a (K, P)-table gather, which XLA
    lowers to a ~10 ns/element scalar loop -- ~0.3 ms per assembled frame
    at 32k capacity, silently dominating the streaming dispatch.  Shifted
    block copies are pure vector moves.  Each copy writes a full P-lane
    segment; slot k+1's copy starts exactly where slot k's real events
    end, overwriting its overhang, and the last overhang lands in a
    P-lane scratch tail (or is masked off by the caller's valid lanes).
    """
    P = tabs[0].shape[0]
    out = jnp.zeros((capacity + P,), tabs[0].dtype)
    for k, tab in enumerate(tabs):
        seg = jax.lax.dynamic_slice(
            jnp.concatenate([tab, jnp.zeros((P,), tab.dtype)]),
            (starts[k],),
            (P,),
        )
        out = jax.lax.dynamic_update_slice(
            out, seg, (jnp.minimum(cum0[k], capacity),)
        )
    return out[:capacity]


def _slot_meta(counts, t_offs, capacity: int):
    """Per-lane validity and time offset from per-slot counts (vector
    compares and selects only -- no gathers)."""
    K = counts.shape[0]
    cum = jnp.cumsum(counts)
    cum0 = jnp.concatenate([jnp.zeros((1,), cum.dtype), cum[:-1]])
    total = cum[-1]
    j = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0).reshape(capacity)
    kc = jnp.sum(j[:, None] >= cum[None, :], axis=1).astype(jnp.int32)
    t_off_lane = jnp.zeros(capacity, jnp.int32)
    for k in range(K):
        t_off_lane = jnp.where(kc == k, t_offs[k], t_off_lane)
    count = jnp.minimum(total, capacity).astype(jnp.int32)
    valid = j < count
    return cum0, t_off_lane, valid, count


def assemble_ring_frame(
    xys: tuple,
    tps: tuple,
    meta: jax.Array,
    capacity: int,
) -> EventBatch:
    """Device-side frame assembly from K resident packet slots.

    ``meta`` is (3, K) int32: row 0 = per-slot start lane, row 1 = per-slot
    event count, row 2 = per-slot time offset (packet t_base minus the
    frame's first event time).  Slot k's events land contiguously at the
    cumulative offset of the slots before it, giving the same contiguous,
    arrival-ordered, capacity-padded batch (and bit-identical timestamps)
    as staging the segmented frame directly.
    """
    starts, counts, t_offs = meta[0], meta[1], meta[2]
    cum0, t_off_lane, valid, count = _slot_meta(counts, t_offs, capacity)
    w_xy = _place_segments(xys, starts, cum0, capacity).astype(jnp.int32)
    w_tp = _place_segments(tps, starts, cum0, capacity)
    # zero the padding lanes exactly like the segmented staging does, so
    # the assembled batch is bit-identical to EventBatch.from_structured
    zero = jnp.int32(0)
    x = jnp.where(valid, w_xy & 0xFFFF, zero)
    y = jnp.where(valid, (w_xy >> 16) & 0xFFFF, zero)
    t = jnp.where(valid, (w_tp & _T_MASK) + t_off_lane, zero)
    p = jnp.where(valid, w_tp >> _P_SHIFT, zero)
    return EventBatch(x=x, y=y, t=t, p=p, valid=valid, count=count)


def assemble_ring_frame_compact(
    ws: tuple,
    meta: jax.Array,
    capacity: int,
    layout: RingLayout,
) -> EventBatch:
    """:func:`assemble_ring_frame` for compact (one-word) ring packets.

    Same placement, one segment stream instead of two, and p
    reconstructed as the constant 1 the upstream polarity filter
    guarantees.  Bit-identical to EventBatch.from_structured of the
    segmented slice (tests/test_prefetch.py)."""
    starts, counts, t_offs = meta[0], meta[1], meta[2]
    cum0, t_off_lane, valid, count = _slot_meta(counts, t_offs, capacity)
    word = _place_segments(ws, starts, cum0, capacity).astype(jnp.int32)
    zero = jnp.int32(0)
    bx, by = layout.bits_x, layout.bits_y
    x = jnp.where(valid, word & ((1 << bx) - 1), zero)
    y = jnp.where(valid, (word >> bx) & ((1 << by) - 1), zero)
    # logical shift: the word is packed unsigned (u32 reinterpreted)
    t_rel = jax.lax.shift_right_logical(word, jnp.int32(bx + by))
    t = jnp.where(valid, t_rel + t_off_lane, zero)
    p = jnp.where(valid, jnp.int32(1), zero)
    return EventBatch(x=x, y=y, t=t, p=p, valid=valid, count=count)


class PacketRing:
    """Preallocated host slots + live device packets for pre-staging.

    Slots are reused oldest-first once their packet has been retired
    (every event below the trigger finder's buffer base is final: frames
    are emitted in order and push-back never reaches behind it).  Slot
    count defaults to 4 frames of packets so a slot is never rewritten
    while a frame referencing it is still in flight.
    """

    def __init__(
        self,
        packet_capacity: int,
        n_slots: int = 16,
        device: Optional[jax.Device] = None,
        layout: Optional[RingLayout] = None,
    ):
        assert n_slots >= 2 * RING_SLOTS_PER_FRAME
        self.packet_capacity = packet_capacity
        self.device = device
        self.layout = layout
        if layout is not None:
            self._slots = [
                {"w": np.zeros(packet_capacity, np.uint32)}
                for _ in range(n_slots)
            ]
        else:
            self._slots = [
                {
                    "xy": np.zeros(packet_capacity, np.uint32),
                    "tp": np.zeros(packet_capacity, np.int32),
                }
                for _ in range(n_slots)
            ]
        self._free = list(range(n_slots))
        self._live: list[RingPacket] = []  # sorted by gbase
        self._next_global = 0
        self.packets_staged = 0
        self.overruns = 0

    def reset(self):
        self._free = list(range(len(self._slots)))
        self._live.clear()
        self._next_global = 0

    def stage_packets(self, evs: np.ndarray) -> bool:
        """Stage one arrival packet (split into slot-capacity chunks).

        Numbering MUST mirror the trigger finder's: both see the same
        post-filter packet stream.  Returns False (and stages nothing
        more) on ring overrun -- frames touching unstaged ranges fall
        back to segmented staging.
        """
        P = self.packet_capacity
        off = 0
        while off < len(evs):
            end = min(off + P, len(evs))
            if self.layout is not None:
                # bound the chunk's span to the layout's t_rel field
                # (arrival packets are delta_t ~4.2 ms < 2^13 us, so
                # this split only fires on abnormal streams)
                tmax = int(evs["t"][off]) + (1 << self.layout.bits_t) - 1
                if int(evs["t"][end - 1]) > tmax:
                    end = off + int(
                        np.searchsorted(evs["t"][off:end], tmax, "right")
                    )
            chunk = evs[off:end]
            if not self._free:
                self.overruns += 1
                self._next_global += len(evs) - off
                return False
            slot_id = self._free.pop(0)
            slot = self._slots[slot_id]
            n = len(chunk)
            t64 = chunk["t"].astype(np.int64, copy=False)
            t_base = int(t64[0])

            if self.layout is not None:
                # ONE packed word/event: x | y << bx | t_rel << (bx+by).
                # Polarity carries no bit -- the upstream polarity filter
                # already dropped p == 0 (RingLayout contract).
                bx, by = self.layout.bits_x, self.layout.bits_y
                w = slot["w"]
                np.subtract(t64, t_base, out=w[:n], casting="unsafe")
                np.left_shift(w[:n], bx + by, out=w[:n])
                np.bitwise_or(w[:n], chunk["x"].astype(np.uint32), out=w[:n])
                np.bitwise_or(
                    w[:n],
                    chunk["y"].astype(np.uint32) << np.uint32(bx),
                    out=w[:n],
                )
                xy_d = jax.device_put(w, self.device)
                tp_d = None
            else:
                xy = slot["xy"]
                np.left_shift(
                    chunk["y"].astype(np.uint32), 16,
                    out=xy[:n], casting="unsafe",
                )
                np.bitwise_or(xy[:n], chunk["x"].astype(np.uint32), out=xy[:n])

                tp = slot["tp"]
                np.subtract(t64, t_base, out=tp[:n], casting="unsafe")
                np.bitwise_or(
                    tp[:n],
                    (chunk["p"].astype(np.int32) & 1) << _P_SHIFT,
                    out=tp[:n],
                )
                # stale lanes beyond n are never addressed (per-slot
                # counts bound the assembly gather), so only [:n] must be
                # fresh; ship the full slot for one static shape
                xy_d, tp_d = jax.device_put((xy, tp), self.device)

            self._live.append(
                RingPacket(
                    xy=xy_d,
                    tp=tp_d,
                    gbase=self._next_global,
                    count=n,
                    t_base=t_base,
                    slot=slot_id,
                )
            )
            self._next_global += n
            self.packets_staged += 1
            off = end
        return True

    def skip_events(self, num_events: int):
        """Advance the global EVENT numbering past ``num_events`` events
        WITHOUT staging them (used while the watchdog is dropping frames:
        bytes of a doomed frame should never cross the host->device link).
        Frames that later turn out to span a skipped range simply miss
        residency and take the segmented-staging fallback."""
        assert num_events >= 0, num_events
        self._next_global += num_events

    def retire_below(self, gmin: int):
        """Free slots whose packets end at or before global index gmin."""
        keep = []
        for pkt in self._live:
            if pkt.gbase + pkt.count <= gmin:
                self._free.append(pkt.slot)
            else:
                keep.append(pkt)
        self._live = keep

    def frame_meta(
        self, gs: int, ge: int, frame_t0: int
    ) -> Optional[tuple[list, np.ndarray]]:
        """Packets + (3, K) meta covering global range [gs, ge), or None
        if the range is not fully resident (overrun/reset) or spans more
        than RING_SLOTS_PER_FRAME packets."""
        K = RING_SLOTS_PER_FRAME
        pkts, starts, counts, t_offs = [], [], [], []
        covered = gs
        for pkt in self._live:
            if pkt.gbase + pkt.count <= gs or pkt.gbase >= ge:
                continue
            if pkt.gbase > covered:
                return None  # hole (events were never staged)
            s = max(gs - pkt.gbase, 0)
            e = min(ge - pkt.gbase, pkt.count)
            pkts.append(pkt)
            starts.append(s)
            counts.append(e - s)
            t_offs.append(pkt.t_base - frame_t0)
            covered = pkt.gbase + e
        if covered < ge or not pkts:
            return None
        if len(pkts) > K:
            return None
        # meta is (3, len(pkts)) -- the consumer specializes its program
        # to the frame's actual packet count (fewer buffer handles and a
        # narrower per-lane slot select than always-8 padding)
        meta = np.stack(
            [
                np.asarray(starts, np.int32),
                np.asarray(counts, np.int32),
                np.asarray(t_offs, np.int32),
            ]
        )
        return pkts, meta
