"""Frame-drop governor for the streaming pipeline.

A soft real-time stream must consume events at the sensor's clock rate.
The watchdog anchors a (wall time, event time) pair at the first packet
of the stream and, per packet, measures how far wall-clock processing
has slipped behind the event clock.  Once the slip exceeds a whole
projector period the pipeline asks the trigger finder to discard one
frame's worth of buffered events (reference behavior:
timing_watchdog.py + depth_reprojection_pipe.py:111-112; disabled with
--no-frame-dropping).

Unlike the reference, the anchor is owned here rather than borrowed from
the stats clock, so silencing or resetting the dashboard cannot skew
drop decisions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from xmaps.utils.stats import StatsPrinter


@dataclass
class TimingWatchdog:
    stats_printer: StatsPrinter
    projector_fps: int

    _anchor_wall_ns: int = -1
    _anchor_event_us: int = -1

    def is_processing_behind(self, evs) -> bool:
        """Called once per packet with decoded events; True = drop a frame."""
        if len(evs) == 0:
            return False
        now_ns = time.perf_counter_ns()
        t_first = int(evs["t"][0])
        if self._anchor_wall_ns < 0:
            self._anchor_wall_ns = now_ns
            self._anchor_event_us = t_first
            # stream is live: restart the dashboard's global window too
            self.stats_printer.reset()
            return False

        stream_ns = (t_first - self._anchor_event_us) * 1000
        wall_ns = now_ns - self._anchor_wall_ns
        lag_ns = wall_ns - stream_ns
        self.stats_printer.add_time_measure_ns("stream lag", lag_ns)

        frames_behind = int(lag_ns * self.projector_fps / 1e9)
        self.stats_printer.add_metric("frames behind", frames_behind)
        return frames_behind > 0

    def reset(self):
        self._anchor_wall_ns = -1
        self._anchor_event_us = -1
