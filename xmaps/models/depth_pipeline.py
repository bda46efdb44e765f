"""XMapsDepthEngine: the flagship event->depth model.

Owns the one-time init (calibration load, LUT construction, X-map build --
reference init path SURVEY.md §3.4) and the per-frame jitted program.  This
is the device-side counterpart of the reference's DepthReprojectionPipe
setup (depth_reprojection_pipe.py:64-108); streaming orchestration lives in
xmaps.runtime.
"""

from __future__ import annotations

import functools
import hashlib
import os
from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from xmaps.calib.maps import CalibrationParams, CamProjMaps
from xmaps.config import PipelineConfig, RuntimeParams
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import (
    DeviceTables,
    FrameResult,
    depth_frame,
    make_depth_frame_fn,
)
from xmaps.ops.image_tail import tail_crop_window
from xmaps.ops.xmap import build_x_map, build_x_map_numpy
from xmaps.utils.cache import cache_dir


def check_platform(platform: str) -> None:
    """The engine runs on an NVIDIA GPU (``gpu``) or, for tests and
    rehearsals, on the CPU; any other platform is refused rather than
    run on an untested path."""
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"unsupported platform {platform!r}: expected gpu or cpu")


def _named_partial(fn, name: str, **kw):
    """functools.partial whose __name__ survives into the jitted HLO
    module name (``jit_<name>``), so profiler traces identify the frame
    programs instead of showing ``jit__unknown``."""
    p = functools.partial(fn, **kw)
    p.__name__ = name
    return p


def _xmap_cache_key(time_map: np.ndarray, x_map_width: int, t_px_scale: int,
                    num_scanlines: int) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(time_map).tobytes())
    h.update(f"{x_map_width}|{t_px_scale}|{num_scanlines}".encode())
    return h.hexdigest()[:24]


@dataclass
class XMapsDepthEngine:
    """End-to-end depth pipeline bound to one calibration.

    Build with :meth:`from_calibration` (or :meth:`from_runtime_params` for
    CLI use).  ``process_frame`` turns one frame's events into a colorized
    depth map in a single device program.
    """

    cfg: PipelineConfig
    maps: CamProjMaps
    tables: DeviceTables
    x_map_np: np.ndarray
    time_map_rect: np.ndarray

    _frame_fn: object = field(init=False, default=None, repr=False)
    _staged_fn: object = field(init=False, default=None, repr=False)
    _staged_compact_fn: object = field(init=False, default=None, repr=False)
    _ring_fn: object = field(init=False, default=None, repr=False)
    #: io.prefetch.CompactLayout when 1-word staging is available
    compact_layout: object = field(init=False, default=None, repr=False)

    def __post_init__(self):
        self._build_frame_fns()

    def _build_frame_fns(self):
        from xmaps.io.prefetch import (
            CompactLayout,
            CompactStagedBatch,
            RingLayout,
            assemble_ring_frame,
            assemble_ring_frame_compact,
            unpack_staged,
            unpack_staged_compact,
        )

        self._frame_fn = make_depth_frame_fn(self.cfg)
        frame = functools.partial(
            depth_frame, display_only=True, display_packed=True
        )

        # The streaming programs run display-only: the runtime's frame
        # callback consumes the colorized frame + the inlier count, and
        # the reference's per-frame path likewise emits only the frame
        # (depth/disparity are intermediates, disp_to_depth.py).
        def staged_frame(staged, tables, cfg):
            return frame(unpack_staged(staged), tables, cfg)

        self._staged_fn = jax.jit(
            _named_partial(staged_frame, "staged_frame", cfg=self.cfg)
        )

        def ring_frame(xys, tps, meta, tables, cfg):
            batch = assemble_ring_frame(xys, tps, meta, cfg.event_capacity)
            return frame(batch, tables, cfg)

        self._ring_fn = jax.jit(
            _named_partial(ring_frame, "ring_frame", cfg=self.cfg)
        )

        # compact (one-word) ring staging: valid whenever the camera dims
        # leave >= 13 t_rel bits (io.prefetch.RingLayout) -- the pipe
        # stages post-polarity-filter, satisfying the p == 1 contract
        self.ring_layout = RingLayout.for_camera(
            self.cfg.camera_width, self.cfg.camera_height
        )
        self._ring_compact_fn = None
        if self.ring_layout is not None:
            rlayout = self.ring_layout

            def ring_frame_compact(ws, meta, tables, cfg):
                batch = assemble_ring_frame_compact(
                    ws, meta, cfg.event_capacity, rlayout
                )
                return frame(batch, tables, cfg)

            self._ring_compact_fn = jax.jit(
                _named_partial(
                    ring_frame_compact, "ring_frame_compact", cfg=self.cfg
                )
            )

        # 1-word-per-event staging layout (pure geometry; None if the
        # dims don't fit 32 bits).  The jitted consumer exists only for
        # unfiltered pipelines: the dedup filters re-bin time after
        # dropping events, so they need raw timestamps (2-word staging).
        self.compact_layout = CompactLayout.for_pipeline(self.cfg)
        self._staged_compact_fn = None
        if self.compact_layout is not None and self.cfg.frame_filter == "none":
            layout = self.compact_layout

            def staged_compact_frame(word, count, tables, cfg, presorted):
                batch, ts = unpack_staged_compact(
                    CompactStagedBatch(word, count), layout
                )
                kw = {}
                if presorted:
                    # host target-sorted staging (compact_presort): the
                    # stable sort preserves arrival order within a target,
                    # so the lane index IS a valid last-write-wins
                    # priority -- no priority upload needed
                    kw = dict(
                        presort_priority=jnp.arange(
                            batch.x.shape[0], dtype=jnp.int32
                        ),
                        presort_runs=True,
                    )
                return frame(batch, tables, cfg, t_scaled=ts, **kw)

            self._staged_compact_fn = jax.jit(
                _named_partial(
                    staged_compact_frame, "staged_compact_frame", cfg=self.cfg
                ),
                static_argnames=("presorted",),
            )

    # -- construction --------------------------------------------------

    @staticmethod
    def from_calibration(
        calib: CalibrationParams,
        *,
        event_capacity: int = 65536,
        z_near: float = 0.1,
        z_far: float = 1.0,
        camera_perspective: bool = False,
        scan_upwards: bool = True,
        # False = the reference's EXECUTED border behavior (its
        # border_mode lands in cv2.remap's dst slot and never applies;
        # see calib.maps.build_rectified_time_map)
        border_replicate: bool = False,
        zero_undistort_proj_map: bool = False,
        projector_time_map_path: Optional[str] = None,
        xmap_cache_dir: Optional[str] = None,
        use_device_xmap_build: bool = True,
    ) -> "XMapsDepthEngine":
        import time as _time

        _trace = os.environ.get("XMAPS_SETUP_TRACE") == "1"
        _t0 = _time.perf_counter()
        _timings: list = []  # (label, seconds since previous mark)
        _prev = [_t0]

        def _mark(label):
            now = _time.perf_counter()
            _timings.append((label, now - _prev[0]))
            _prev[0] = now
            if _trace:
                import sys

                print(
                    f"[setup +{now - _t0:7.2f}s] {label}",
                    file=sys.stderr,
                    flush=True,
                )

        check_platform(jax.devices()[0].platform)
        maps = CamProjMaps.build_cached(
            calib,
            zero_undistort_proj_map=zero_undistort_proj_map,
            cache_dir=xmap_cache_dir,
        )
        _mark("CamProjMaps (host calibration math, disk-cached)")
        cfg = PipelineConfig(
            camera_width=calib.camera_width,
            camera_height=calib.camera_height,
            projector_width=calib.projector_width,
            projector_height=calib.projector_height,
            rect_width=calib.rect_image_width,
            rect_height=calib.rect_image_height,
            p03=float(maps.P2[0, 3]),
            event_capacity=event_capacity,
            z_near=z_near,
            z_far=z_far,
            camera_perspective=camera_perspective,
            tail_crop=tail_crop_window(
                maps.disp_proj_mapx_i16,
                maps.disp_proj_mapy_i16,
                calib.rect_image_height,
                calib.rect_image_width,
            ),
        )

        if projector_time_map_path is not None:
            # precalibrated rectified time map (reference proj_time_map.py:47-49)
            time_map_rect = np.load(projector_time_map_path)
        else:
            time_map_rect = maps.build_rectified_time_map(
                scan_upwards=scan_upwards, border_replicate=border_replicate
            )

        x_map_np = XMapsDepthEngine._build_or_load_xmap(
            time_map_rect, cfg, xmap_cache_dir, use_device_xmap_build
        )
        _mark("X-map build/load")

        tables = DeviceTables.from_maps(maps, x_map_np)
        _mark("DeviceTables H2D")

        eng = XMapsDepthEngine(
            cfg=cfg,
            maps=maps,
            tables=tables,
            x_map_np=x_map_np,
            time_map_rect=time_map_rect,
        )
        _mark("frame fns wrapped (jit, untraced)")
        #: per-step wall-clock breakdown of this build (label, seconds)
        eng.setup_timings = list(_timings)
        return eng

    @staticmethod
    def from_runtime_params(params: RuntimeParams, **kw) -> "XMapsDepthEngine":
        calib = CalibrationParams.from_yaml(
            params.calib,
            params.camera_width,
            params.camera_height,
            params.projector_width,
            params.projector_height,
        )
        # CLI sessions reuse the X-map across runs (checkpoint/resume
        # analog, SURVEY.md §5); the key hashes the time map + geometry.
        kw.setdefault(
            "xmap_cache_dir", cache_dir("tables")
        )
        return XMapsDepthEngine.from_calibration(
            calib,
            z_near=params.z_near,
            z_far=params.z_far,
            camera_perspective=params.camera_perspective,
            projector_time_map_path=params.projector_time_map,
            **kw,
        )

    @staticmethod
    def _build_or_load_xmap(
        time_map_rect: np.ndarray,
        cfg: PipelineConfig,
        cache_dir: Optional[str],
        use_device: bool,
    ) -> np.ndarray:
        """Build the X-map (the heavy init step), with optional disk cache
        -- the checkpoint/resume analog of this framework (SURVEY.md §5)."""
        key = _xmap_cache_key(
            time_map_rect, cfg.x_map_width, cfg.t_px_scale, cfg.projector_width
        )
        cache_path = None
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            cache_path = os.path.join(cache_dir, f"xmap_{key}.npy")
            if os.path.exists(cache_path):
                return np.load(cache_path)

        if use_device:
            x_map, _ = build_x_map(
                jnp.asarray(time_map_rect),
                x_map_width=cfg.x_map_width,
                t_px_scale=cfg.t_px_scale,
                num_scanlines=cfg.projector_width,
            )
            x_map = np.asarray(jax.device_get(x_map))
        else:
            x_map, _ = build_x_map_numpy(
                time_map_rect,
                x_map_width=cfg.x_map_width,
                t_px_scale=cfg.t_px_scale,
                num_scanlines=cfg.projector_width,
            )

        if cache_path:
            np.save(cache_path, x_map)
        return x_map

    # -- per-frame API ---------------------------------------------------

    def make_batch(self, events: np.ndarray) -> EventBatch:
        return EventBatch.from_structured(events, self.cfg.event_capacity)

    def make_sorted_batch(self, events: np.ndarray):
        """Host-staged batch sorted by scatter target, plus the carried
        arrival-index priorities: returns (batch, priority) for
        depth_frame(presort_priority=priority, presort_runs=True).

        The host mirrors the scatter target exactly for integer
        timestamps: the clipped rectified row, then the raw X-map value
        x_map[yg, clip(t_bin)] for the projector view (the host reuses
        the exact integer time-binning of io.prefetch compact staging) or
        the raw coordinates for the camera view.  Same-target lanes are
        then contiguous, so the device scatter finds each pixel's winner
        with a neighbour compare (ops.scatter method="runs") instead of a
        scatter-max.  Results are bit-identical to arrival-order staging
        (the priority carries the arrival index).
        """
        from xmaps.io.prefetch import _scale_time_int_host

        cap = self.cfg.event_capacity
        n = min(len(events), cap)
        events = events[:n]
        if n and not np.issubdtype(events.dtype["t"].type, np.integer):
            # EventBatch.from_structured_sorted stores t as int64 -- a
            # float stream would be silently truncated, and the host
            # cannot mirror float time binning.  Integer timestamps are
            # what every real EVT stream carries; float streams take the
            # unsorted path.
            raise ValueError(
                "make_sorted_batch requires integer timestamps (host "
                "target-sorting mirrors the integer time binning); use "
                "make_batch/process_frame for float-t streams"
            )
        ts = _scale_time_int_host(events["t"], self.cfg.t_px_scale)
        key, _ = self._host_target_key(events, ts)
        return EventBatch.from_structured_sorted(events, cap, key=key)

    def _host_target_key(self, events: np.ndarray, ts: np.ndarray):
        """(sort key, inlier) for host target-sorting: the clipped
        rectified row, then the exact scatter target that ``ts``
        (host-binned X-map time) lets the host mirror -- the raw X-map
        value for the projector view, raw coordinates for the camera
        view.  ``inlier`` mirrors the device's per-event inlier mask
        (ops.disparity: rect row in range, disp >= 0, time bin in the
        X-map) bit-for-bit.

        The key's low bit is the scatter's exact ``ok`` mask (inlier +
        crop-window bounds + disp < PACK -- every term is integer LUT
        math the host reproduces bit-for-bit), so a stable sort leaves
        each run as [rejects..., kept in arrival order]: the run's winner
        is then its LAST kept lane and the device scatter needs only a
        neighbor compare (ops.scatter method="runs")."""
        from xmaps.config import X_OFFSET
        from xmaps.ops.scatter import PACK

        mapy = self.maps.disp_cam_mapy_i16
        xmap_h, xmap_w = self.x_map_np.shape
        # Clip the LUT indices exactly like the device path
        # (ops.disparity.rectify_events*, jnp.clip to the camera dims): a
        # malformed stream with out-of-range x/y must degrade to the same
        # masked lanes the device produces, not an IndexError (or a
        # silently different row via negative wrapping) in host staging.
        yi = np.clip(events["y"].astype(np.int64), 0, mapy.shape[0] - 1)
        xi = np.clip(events["x"].astype(np.int64), 0, mapy.shape[1] - 1)
        yr = mapy[yi, xi].astype(np.int32)
        yg = np.clip(yr, 0, xmap_h - 1)
        xr = self.maps.disp_cam_mapx_i16[yi, xi].astype(np.int32)
        tg = np.clip(ts, 0, xmap_w - 1)
        x_proj = self.x_map_np[yg, tg].astype(np.int32)
        disp = x_proj - xr - X_OFFSET
        # mirrors ops.disparity inlier math: rectified row in-range
        # (padding-lane validity is moot -- only real lanes are sorted),
        # non-negative disparity, time bin in the X-map
        inlier = (
            (yr >= 0)
            & (yr < xmap_h - 1)
            & (disp >= 0)
            & (ts >= 0)
            & (ts < xmap_w)
        )
        ok = inlier & (disp < PACK)
        if self.cfg.camera_perspective:
            # raw-coordinate targets; decoder coords are in-bounds by
            # construction, mirrored anyway for exactness
            ok &= (events["y"] < self.cfg.camera_height) & (
                events["x"] < self.cfg.camera_width
            )
            sec = (
                events["y"].astype(np.int64) * self.cfg.camera_width
                + events["x"]
            )
        else:
            # target pixel (y_rect, x_proj - X_OFFSET); bounds are the
            # tail's crop window, or the full rect frame without one
            oy, ox, wh, ww = self.cfg.tail_crop or (
                0, 0, self.cfg.rect_height, self.cfg.rect_width
            )
            xt = x_proj - X_OFFSET
            ok &= (
                (yr >= oy) & (yr < oy + wh) & (xt >= ox) & (xt < ox + ww)
            )
            # X-map values are non-negative i16, so the raw value is its
            # own order key (matches the device's x_proj exactly)
            sec = x_proj.astype(np.int64)
        assert xmap_h <= (1 << 26) and int(sec.max(initial=0)) < (1 << 26)
        key = (yg.astype(np.int64) << 27) | (sec << 1) | ok
        return key, inlier

    def compact_presort(self, events: np.ndarray, ts: np.ndarray):
        """Host target-sort hook for io.prefetch compact staging
        (HostStagingPool presort_fn): the order that stable-sorts the
        frame's events by scatter target.  The staged lane index then
        works as the last-write-wins priority (stable keeps arrival
        order within a target) and the device scatter runs sort-free
        (depth_frame(presort_runs=True))."""
        key, _ = self._host_target_key(events, ts)
        return np.argsort(key, kind="stable")

    #: static winner-batch capacities: one compiled program per rung,
    #: smallest rung that fits the frame's winner count wins
    WINNER_LADDER = (4096, 8192, 12288, 16384, 20480, 24576, 28672)

    class WinnerBatch(tuple):
        """(batch, t_scaled, priority, num_inliers) -- a host-compacted winner batch for depth_frame(presort_unique=True).

        ``batch`` carries ONLY each target pixel's winning event (the
        host mirrors the scatter's winner resolution exactly:
        [[tests/test_scatter_runs]] pins host ok == device keep), padded
        to the smallest WINNER_LADDER rung; ``priority`` carries the
        winners' ORIGINAL arrival indices so the packed disparity map is
        bit-identical to the full-batch path's; ``num_inliers`` is the
        host-mirrored count over the FULL frame (the compacted batch
        lost the losing inlier lanes)."""

        def __new__(cls, batch, t_scaled, priority, num_inliers):
            return super().__new__(
                cls, (batch, t_scaled, priority, num_inliers)
            )

    def make_winner_batch(self, events: np.ndarray):
        """Host-compacted winner batch: the scatter-winner lane of every
        target pixel, nothing else (VERDICT r3 item 3's host winner
        pre-compaction).

        The host already mirrors the device's per-event integer math
        bit-for-bit for target sorting (``_host_target_key``); the winner
        of a run is its last kept lane, so extracting winners is one
        vectorized boundary test on the sorted keys.  The device then
        runs the event stage on ~winner-count lanes and the scatter is a
        bare unique-indices set (ops.scatter method="set") -- no device
        sort, no winner detection, ~len/capacity of the scatter work.

        Returns a :class:`WinnerBatch`; requires integer timestamps and
        no frame filter (same contract as make_sorted_batch).
        """
        from xmaps.io.prefetch import _scale_time_int_host

        if self.cfg.frame_filter != "none":
            raise ValueError(
                "winner compaction requires frame_filter == 'none' (the "
                "dedup filters define their own winners)"
            )
        cap = self.cfg.event_capacity
        n = min(len(events), cap)
        events = events[:n]
        if n and not np.issubdtype(events.dtype["t"].type, np.integer):
            raise ValueError(
                "make_winner_batch requires integer timestamps (the host "
                "winner mirror needs the exact integer time binning)"
            )
        ts = (
            _scale_time_int_host(events["t"], self.cfg.t_px_scale)
            if n
            else np.zeros(0, np.int64)
        )
        key, inlier = self._host_target_key(events, ts)
        if n == 0:
            inlier = np.zeros(0, bool)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        ok_s = (key_s & 1).astype(bool)
        if n:
            boundary = np.empty(n, bool)
            boundary[:-1] = key_s[1:] != key_s[:-1]
            boundary[-1] = True
            win = ok_s & boundary
        else:
            win = np.zeros(0, bool)
        widx = order[win]  # winners' arrival indices, in (row, target) order
        n_win = len(widx)

        w_cap = next(
            (w for w in self.WINNER_LADDER if w >= n_win and w <= cap),
            cap,
        )
        batch = EventBatch.from_arrays(
            events["x"][widx],
            events["y"][widx],
            events["t"][widx],
            events["p"][widx],
            w_cap,
        )
        ts_w = np.zeros(w_cap, np.int32)
        ts_w[:n_win] = ts[widx]
        prio = np.zeros(w_cap, np.int32)
        prio[:n_win] = widx
        return self.WinnerBatch(
            batch,
            jnp.asarray(ts_w),
            jnp.asarray(prio),
            int(inlier.sum()),
        )

    def process_frame(self, events: np.ndarray) -> FrameResult:
        """events: structured array with x/y/t/p (one projector frame)."""
        return self._frame_fn(self.make_batch(events), self.tables)

    def _presort(self, frames: list) -> bool:
        """Whether these frames can be host target-sorted: no frame
        filter (the dedup filters define their own winners) and integer
        timestamps (the host mirrors the integer time binning exactly;
        make_sorted_batch refuses float streams)."""
        return self.cfg.frame_filter == "none" and all(
            np.issubdtype(ev.dtype["t"].type, np.integer) for ev in frames
        )

    def _stage_group(self, frames: list, presort: bool) -> list:
        if presort:
            return [self.make_sorted_batch(ev) for ev in frames]
        cap = self.cfg.event_capacity
        return [(EventBatch.from_structured(ev, cap), None) for ev in frames]

    def process_frames(self, frames: list) -> list:
        """Dispatch many independent frames as ONE device program.

        The multi-camera / offline-batch regime: frames are independent
        (SURVEY §2.3), so a group program lets XLA schedule the F frame
        pipelines back to back -- dispatch overhead amortizes and
        per-frame device time approaches the compute floor (bench.py
        measures exactly this regime).  Host staging target-sorts each
        frame when it can (``_presort``), so the device scatter runs
        sort-free; results are bit-identical to :meth:`process_frame` on
        each element.

        ``frames``: list of structured x/y/t/p arrays.  The group program
        is traced once per distinct group length and cached.

        Returns a list of FrameResult, one per input frame.
        """
        if not frames:
            return []
        presort = self._presort(frames)
        staged = self._stage_group(frames, presort)
        return self._group_fn(len(frames), presort)(staged, self.tables)

    def _group_fn(self, size: int, presort: bool):
        key = (size, presort)
        cache = self.__dict__.setdefault("_group_cache", {})
        if key not in cache:

            def group(staged, tables, cfg):
                return [
                    depth_frame(
                        b,
                        tables,
                        cfg,
                        presort_priority=prio,
                        presort_runs=prio is not None,
                    )
                    for b, prio in staged
                ]

            cache[key] = jax.jit(functools.partial(group, cfg=self.cfg))
        return cache[key]

    def process_frames_sharded(self, frames: list, mesh=None) -> list:
        """Dispatch many independent frames as ONE device program sharded
        over a multi-device mesh's ``data`` axis (the multi-camera /
        multi-sequence live regime scaled across devices; the
        single-device analog is :meth:`process_frames`).

        Each device runs the engine's full per-frame program (host
        target-sorted staging, runs scatter, crop-window tail) on its
        shard of frames; frames are independent so no collectives cross
        the mesh.  Results are bit-identical to :meth:`process_frame` per
        element (tests/test_sharding.py).  The frame list is padded to a
        multiple of the mesh's data size with empty frames (their outputs
        are dropped).

        ``mesh``: a ('data', 'event') Mesh with event == 1; defaults to
        pure data-parallel over all visible devices.
        """
        from xmaps.parallel.sharding import (
            make_group_sharded_pipeline,
            make_mesh,
            shard_staged_group,
        )

        if not frames:
            return []
        if mesh is None:
            mesh = make_mesh(jax.devices(), event=1)
        data = mesh.shape["data"]

        pad = (-len(frames)) % data
        padded = list(frames) + [frames[0][:0]] * pad
        presort = self._presort(frames)
        staged = self._stage_group(padded, presort)

        key = (
            len(padded),
            presort,
            tuple(mesh.shape.items()),
            tuple(d.id for d in mesh.devices.flat),
        )
        cache = self.__dict__.setdefault("_sharded_group_cache", {})
        if key not in cache:
            cache[key] = make_group_sharded_pipeline(
                self.cfg,
                self.tables,
                mesh,
                presort=presort,
            )
        batch, prio = shard_staged_group(staged, mesh)
        out = cache[key](batch, prio)
        return [
            jax.tree.map(lambda a: a[i], out) for i in range(len(frames))
        ]

    def process_batch_device(self, batch: EventBatch) -> FrameResult:
        return self._frame_fn(batch, self.tables)

    def process_staged(self, staged) -> FrameResult:
        """Run the frame program on a packed io.prefetch batch (the
        streaming hot path; validity implied by the count).  Accepts a
        StagedBatch (2 words/event) or, when the pipeline is unfiltered,
        a CompactStagedBatch (1 word/event with host-binned time)."""
        from xmaps.io.prefetch import CompactStagedBatch

        if isinstance(staged, CompactStagedBatch):
            if self._staged_compact_fn is None:
                raise ValueError(
                    "compact staging requires frame_filter == 'none' and "
                    "a 32-bit-fit CompactLayout"
                )
            return self._staged_compact_fn(
                staged.word,
                staged.count,
                self.tables,
                presorted=staged.presorted,
            )
        return self._staged_fn(staged, self.tables)

    def process_ring(self, packets, meta: np.ndarray) -> FrameResult:
        """Run the frame program on device-resident ring packets
        (io.prefetch.PacketRing pre-staging): ``packets`` is the list of
        RingPackets covering the frame, ``meta`` the (3, k) placement
        array from PacketRing.frame_meta.  Only ``meta`` crosses the
        host->device link at dispatch time.

        The program is specialized to the frame's actual packet count k
        (jit caches one executable per distinct k): half the buffer
        handles and a ~k/8 narrower per-lane slot select versus padding
        to RING_SLOTS_PER_FRAME.  Frames span 4-5 packets in steady state
        (4 packets/frame + boundary), so only a handful of variants ever
        compile, and the persistent compile cache makes them one-time."""
        from xmaps.io.prefetch import RING_SLOTS_PER_FRAME as K

        k = len(packets)
        assert 0 < k <= K and meta.shape == (3, k), (k, meta.shape)
        if packets[0].tp is None:
            # compact one-word packets (PacketRing built with RingLayout)
            assert self._ring_compact_fn is not None
            ws = tuple(p.xy for p in packets)
            return self._ring_compact_fn(ws, meta, self.tables)
        xys = tuple(p.xy for p in packets)
        tps = tuple(p.tp for p in packets)
        return self._ring_fn(xys, tps, meta, self.tables)

    def dump_frame_csv(self, events: np.ndarray, csv_path: str) -> int:
        """Write one frame's per-event debug CSV: raw coords, rectified
        coords and disparity for every inlier (the reference's debug dump,
        depth_reprojection_pipe.py:19-34).  Returns the inlier count.

        Runs the per-event stage only (no scatter/tail) and fetches to
        host; intended for offline inspection, not the hot path.
        """
        import csv

        from xmaps.ops.disparity import compute_event_disparity

        batch = self.make_batch(events)
        res = compute_event_disparity(
            batch,
            self.tables.cam_mapx_i16,
            self.tables.cam_mapy_i16,
            self.tables.x_map,
            t_px_scale=self.cfg.t_px_scale,
        )
        keep = np.asarray(res.inlier)
        xr = np.asarray(res.x_rect)[keep]
        yr = np.asarray(res.y_rect)[keep]
        disp = np.asarray(res.disp)[keep]
        x = np.asarray(batch.x)[keep]
        y = np.asarray(batch.y)[keep]
        t = np.asarray(batch.t)[keep]
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "y", "t", "x_r", "y_r", "disp"])
            w.writerows(zip(x, y, t, xr, yr, disp))
        return int(keep.sum())

    @property
    def frame_fn(self):
        """The underlying jitted (batch, tables) -> FrameResult function."""
        return self._frame_fn

    def set_frame_filter(self, name: str):
        """Swap the frame dedup filter (recompiles once per new filter)."""
        self.cfg = self.cfg.replace(frame_filter=name)
        self.__dict__.pop("_group_cache", None)
        self._build_frame_fns()
