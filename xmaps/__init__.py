"""xmaps: an accelerator-native event-camera structured-light depth framework.

A ground-up JAX/XLA rebuild of the capabilities of fraunhoferhhi/X-maps
(CVPRW 2023): real-time depth from an event camera observing a scanning laser
projector.  An event's rectified y-coordinate and its normalized timestamp
within the projector frame index a precomputed "X-map" that yields the
projector column that illuminated it; disparity and depth follow directly.

Layer map (mirrors reference layers, see SURVEY.md):

- ``xmaps.calib``    -- one-time host-side calibration math (NumPy):
  OpenCV-compatible stereo rectification, distortion models, LUT builders.
- ``xmaps.ops``      -- device compute (JAX/XLA): per-event
  rectify/lookup/scatter, dense image tail, X-map construction.
- ``xmaps.models``   -- the flagship end-to-end depth pipeline module.
- ``xmaps.parallel`` -- jax.sharding meshes for multi-chip scale-out.
- ``xmaps.io``       -- host-side event IO: EVT2/EVT3/DAT decoding,
  packet iterators, double-buffered device feed.
- ``xmaps.runtime``  -- streaming orchestration: trigger finder, timing
  watchdog, processor session.
- ``xmaps.utils``    -- stats/observability, colormaps, PLY export.
- ``xmaps.apps``     -- CLI entry points (live/replay app, offline eval).
"""

__version__ = "0.1.0"

from xmaps.config import RuntimeParams, PipelineConfig  # noqa: F401
