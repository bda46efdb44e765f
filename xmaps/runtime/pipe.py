"""Pipeline wiring: packets -> filters -> trigger finder -> device frame.

The orchestration equivalent of the reference DepthReprojectionPipe
(depth_reprojection_pipe.py:38-176).  Per-packet path: watchdog -> fused
polarity+activity filter (native C++) -> trigger finder.  Per-frame path:
ONE fused device program (xmaps.ops.frame_pipeline) replacing the
reference's rectify / filter / disparity / scatter / dilate / remap /
colorize stage chain, plus an async handoff of the finished frame to the
display callback.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

import jax

from xmaps.config import RuntimeParams
from xmaps.io.filters import ActivityNoiseFilter
from xmaps.io.prefetch import HostStagingPool, PacketRing
from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.ops.filters import FILTER_NAMES
from xmaps.runtime.trigger_finder import RobustTriggerFinder
from xmaps.runtime.watchdog import TimingWatchdog
from xmaps.utils.stats import SingleTimer, StatsPrinter


@dataclass
class DepthReprojectionPipe:
    params: RuntimeParams
    stats_printer: StatsPrinter
    frame_callback: Callable[[np.ndarray], None]

    engine: Optional[XMapsDepthEngine] = None

    #: True = flush each frame synchronously (lowest latency); False =
    #: keep one frame in flight so device compute overlaps segmentation
    #: (highest throughput, plus ~1 frame of display delay).
    low_latency: bool = False

    #: Pre-stage every filtered packet to the device as it arrives
    #: (io.prefetch.PacketRing): the frame's event data is already
    #: device-resident when the trigger fires, so dispatch ships only a
    #: (3, K) placement array.  Falls back to segmented staging per
    #: frame on ring overrun.
    prestage: bool = True

    #: Optional display-demand probe, called once per finished frame.
    #: When it returns False the full-resolution frame is never fetched
    #: from the device -- only the 4-byte inlier count (stats +
    #: backpressure).  Sinks that show every Nth frame (FileSinkWindow)
    #: or none at all would otherwise pay the device->host image copy for
    #: frames nobody looks at, which on a slow link is the difference
    #: between keeping up with the camera and drop-spiraling.
    frame_wanted: Optional[Callable[[], bool]] = None

    trigger_finder: RobustTriggerFinder = field(init=False)
    watchdog: TimingWatchdog = field(init=False)
    act_filter: ActivityNoiseFilter = field(init=False)

    _filter_idx: int = 0
    _pending: Optional[object] = None  # in-flight device FrameResult

    def __post_init__(self):
        p = self.params
        self.act_filter = ActivityNoiseFilter(
            p.camera_width,
            p.camera_height,
            window_us=int(1e6 / p.projector_fps),
            keep_polarity=1,
        )

        if self.engine is None:
            with SingleTimer("Setting up calibration, maps and X-map"):
                self.engine = XMapsDepthEngine.from_runtime_params(p)

        self.staging = HostStagingPool(
            self.engine.cfg.event_capacity,
            depth=2,
            layout=self.engine.compact_layout,
            # Host target-sorting during compact staging (engine
            # .compact_presort) would let the device skip both its sorts
            # (~60 us/frame), but the argsort costs ~8 ms/frame on a
            # 1-core host and sits on the event->display critical path --
            # a bad trade for streaming, where device time is far below
            # the frame period.  The pre-staged throughput paths (bench,
            # offline eval, process_frame groups) use it instead; here
            # the device does its own sorts.
            presort_fn=None,
        )
        # Slot capacity tracks the arrival-packet size (a quarter frame,
        # EV_PACKETS_PER_FRAME), not the frame capacity: every staged
        # packet ships its full slot for one static shape, so oversized
        # slots cost link bytes on every packet.  The compact RingLayout
        # (one u32/event; polarity is implied by the upstream filter)
        # halves the bytes again when the camera dims permit.
        self.ring = (
            PacketRing(
                packet_capacity=max(
                    2048, self.engine.cfg.event_capacity // 4
                ),
                layout=self.engine.ring_layout,
            )
            if self.prestage
            else None
        )

        self.trigger_finder = RobustTriggerFinder(
            projector_fps=p.projector_fps,
            stats=self.stats_printer,
            frame_callback=self.process_ev_frame,
            frame_callback_indexed=(
                self.process_ev_frame_indexed if self.ring else None
            ),
        )
        self.watchdog = TimingWatchdog(
            stats_printer=self.stats_printer, projector_fps=p.projector_fps
        )

    # -- per packet -------------------------------------------------------

    def process_events(self, evs: np.ndarray):
        behind = (
            self.watchdog.is_processing_behind(evs)
            and self.params.should_drop_frames
        )
        if behind:
            self.trigger_finder.drop_frame()

        with self.stats_printer.measure_time("act+pol filter"):
            evs = self.act_filter.process(evs)

        if self.ring is not None and len(evs):
            if behind:
                # The watchdog is dropping frames to catch up; shipping a
                # doomed frame's bytes to the device would only deepen the
                # lag (on a slow host->device link the per-packet copy is
                # the lag).  Keep the ring's numbering in sync and let any
                # surviving frame that spans this range use the segmented
                # fallback.
                self.ring.skip_events(len(evs))
            else:
                with self.stats_printer.measure_time("prestage packet"):
                    self.ring.stage_packets(evs)

        self.trigger_finder.process_events(evs)

    # -- per frame ---------------------------------------------------------

    def process_ev_frame_indexed(self, evs: np.ndarray, gstart: int):
        """Indexed trigger-finder callback (pre-staging mode): the frame's
        events are already device-resident ring packets; dispatch ships
        only their placement metadata."""
        self._flush_pending()

        meta_out = (
            self.ring.frame_meta(
                gstart, gstart + len(evs), int(evs["t"][0])
            )
            if len(evs)
            else None
        )
        if meta_out is None:
            # overrun/hole: this frame's packets are not (all) resident
            self.stats_printer.count("ring fallback")
            self._dispatch_segmented(evs)
        else:
            pkts, meta = meta_out
            with self.stats_printer.measure_time("dispatch frame"):
                result = self.engine.process_ring(pkts, meta)
            self._pending = result
            self.stats_printer.count("frames dispatched")
        self.ring.retire_below(self.trigger_finder.buffer_global_base)
        if self.low_latency:
            self._flush_pending()

    def process_ev_frame(self, evs: np.ndarray):
        """Trigger-finder callback: one frame of events -> device program.

        The previous frame's device result is collected first, so device
        compute overlaps with the next frame's host-side segmentation
        (double buffering; the EventBatch staging alternates buffers).
        """
        self._flush_pending()
        self._dispatch_segmented(evs)
        if self.low_latency:
            self._flush_pending()

    def _dispatch_segmented(self, evs: np.ndarray):
        with self.stats_printer.measure_time("stage batch"):
            # reused host buffers, packed words, async H2D (io.prefetch);
            # the copy overlaps host-side segmentation.  Unfiltered
            # pipelines ship ONE word/event (host-binned time); dedup
            # filters need raw timestamps, so they use the 2-word form.
            if (
                self.engine.compact_layout is not None
                and self.engine.cfg.frame_filter == "none"
            ):
                batch = self.staging.stage_compact(evs)
            else:
                batch = self.staging.stage(evs)
        with self.stats_printer.measure_time("dispatch frame"):
            result = self.engine.process_staged(batch)
        self._pending = result
        self.stats_printer.count("frames dispatched")

    def _flush_pending(self):
        if self._pending is None:
            return
        if self.frame_wanted is not None and not self.frame_wanted():
            # display skipped: sync on the scalar only (completion proof
            # and staging-slot backpressure; the image stays on device)
            with self.stats_printer.measure_time("fetch stats"):
                self.stats_printer.add_metric(
                    "frame inliers", int(self._pending.num_inliers)
                )
            self._pending = None
            self.stats_printer.count("frames computed (display skipped)")
            return
        with self.stats_printer.measure_time("fetch frame"):
            frame = np.asarray(jax.device_get(self._pending.frame_bgr))
            if frame.dtype == np.uint32:
                # packed-BGR display plane (frame_pipeline display_packed):
                # the device skips the channel split + interleave; this
                # host-side view + copy runs at display rate only (the
                # u32 view needs a contiguous last axis)
                h, w = frame.shape
                frame = np.ascontiguousarray(
                    np.ascontiguousarray(frame)
                    .view(np.uint8)
                    .reshape(h, w, 4)[..., :3]
                )
            self.stats_printer.add_metric(
                "frame inliers", int(self._pending.num_inliers)
            )
        self._pending = None
        self.frame_callback(frame)

    def flush(self):
        """Drain the in-flight frame (call at end of stream)."""
        self._flush_pending()

    # -- runtime controls ---------------------------------------------------

    def select_next_frame_event_filter(self) -> str:
        """Cycle the frame dedup filter (reference E key,
        depth_reprojection_pipe.py:169-171).  Recompiles on first use of a
        new filter (cached afterwards)."""
        self._filter_idx = (self._filter_idx + 1) % len(FILTER_NAMES)
        name = FILTER_NAMES[self._filter_idx]
        self.engine.set_frame_filter(name)
        self.stats_printer.log(f"Selected event filter: {name}")
        return name

    def reset(self):
        self.flush()
        self.watchdog.reset()
        self.trigger_finder.reset()
        self.act_filter.reset()
        if self.ring is not None:
            self.ring.reset()
