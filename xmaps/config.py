"""Configuration types and framework-wide constants.

Mirrors the reference's three config tiers (SURVEY.md §5 "Config / flag
system"): CLI options -> RuntimeParams dataclass
(reference: depth_reprojection_processor.py:13-36), calibration YAML
(cam_proj_calibration.py:77-140), and in-code constants
(depth_reprojection.py:66, trigger_finder.py:8,98, x_maps_disparity.py:49).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# --- In-code constants of the reference, kept name-compatible -------------

#: Events per projector frame are streamed in this many packets
#: (reference: depth_reprojection.py:66).
EV_PACKETS_PER_FRAME = 4

#: A candidate frame must contain more events than this
#: (reference: trigger_finder.py:8).
MIN_EVENTS_PER_FRAME = 1000

#: Inter-event gap [us] that marks a projector blanking pause
#: (reference: trigger_finder.py:98).
FRAME_PAUSED_THRESH_US = 40

#: Offset added to X-map entries so that x==0 is distinguishable from
#: "undefined" (reference: x_maps_disparity.py:49).
X_OFFSET = 4242

#: Rectified image size = rectification_scale * camera size for the live
#: calibration dialect (reference: cam_proj_calibration.py:84) and
#: rectification_scale * projector size for the ESL dialect (:117).
RECTIFICATION_SCALE_XMAPS = 2.75
RECTIFICATION_SCALE_ESL = 3.0

#: Dilation kernel size for the projector-view disparity map
#: (reference: disp_to_depth.py:74).
DILATE_KERNEL = 7


@dataclass
class RuntimeParams:
    """Runtime parameters of the live/replay app.

    Field-compatible with the reference RuntimeParams
    (depth_reprojection_processor.py:13-36).
    """

    camera_width: int
    camera_height: int

    projector_width: int
    projector_height: int

    projector_fps: int

    z_near: float
    z_far: float

    calib: str

    projector_time_map: Optional[str] = None

    no_frame_dropping: bool = False

    camera_perspective: bool = False

    @property
    def should_drop_frames(self) -> bool:
        return not self.no_frame_dropping


@dataclass(frozen=True)
class PipelineConfig:
    """Static (trace-time) configuration of the device frame pipeline.

    Everything here is baked into the compiled XLA program: shapes must be
    static under jit.  ``event_capacity`` is the fixed size of the padded
    per-frame event batch; frames with fewer events carry a validity mask,
    frames with more are truncated (the reference never exceeds ~64k events
    per frame on the ESL dataset).
    """

    camera_width: int
    camera_height: int
    projector_width: int
    projector_height: int
    rect_width: int
    rect_height: int

    #: P2[0, 3] of the rectified projector (baseline * focal): depth =
    #: p03 / disparity (ops.image_tail.disparity_luts)
    p03: float

    event_capacity: int = 65536

    z_near: float = 0.1
    z_far: float = 1.0

    camera_perspective: bool = False

    #: One of xmaps.ops.filters.FILTER_NAMES; the reference cycles these
    #: with the E key (frame_event_filter.py:131-151).
    frame_filter: str = "none"

    #: (row0, col0, H, W) window of the rectified frame that the
    #: projector-view tail can see (ops.image_tail.tail_crop_window); the
    #: scatter and the dense tail run on it alone.  None = the full frame.
    tail_crop: Optional[tuple[int, int, int, int]] = None

    #: X-map time axis discretization; reference uses projector_width bins
    #: (x_maps_disparity.py:55-59).
    @property
    def x_map_width(self) -> int:
        return self.projector_width

    @property
    def t_px_scale(self) -> int:
        return self.x_map_width - 1

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)
