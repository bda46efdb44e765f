"""Device compute ops (JAX/XLA).

The per-frame hot path of the reference (depth_reprojection_pipe.py:121-167)
is rebuilt here as a single fused XLA program over fixed-capacity padded
event batches:

- ``event_batch``   -- the SoA padded event batch pytree
- ``xmap``          -- X-map construction (one-time, device)
- ``disparity``     -- per-event rectify gathers + temporal X-map lookup
- ``scatter``       -- deterministic last-write-wins disparity-map scatter
- ``image_tail``    -- dilate / remap / depth / normalize / colorize
- ``filters``       -- polarity, activity-noise and frame dedup filters
- ``frame_pipeline``-- the composed jitted frame function
"""

from xmaps.ops.event_batch import EventBatch  # noqa: F401
