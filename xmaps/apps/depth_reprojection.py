"""Live/replay depth estimation CLI.

Flag-compatible with the reference entry point
(depth_reprojection.py:32-61), plus options for the display sink.

    python -m xmaps.apps.depth_reprojection \
        --calib data/calib.yaml --input recording.raw \
        --projector-width 720 --projector-height 1280
"""

from __future__ import annotations

import argparse
import sys

from xmaps.config import EV_PACKETS_PER_FRAME, RuntimeParams
from xmaps.io.event_iterator import FileEventsIterator
from xmaps.runtime.processor import DepthReprojectionProcessor


def project_events(bias, input, capture, params, delta_t, ev_processor):
    """Replay/live loop: pull delta_t packets through the processor
    (reference: depth_reprojection.py:10-29)."""
    if input:
        mv_iterator = FileEventsIterator(
            input_filename=input, delta_t=delta_t, bias_file=bias
        )
    else:
        # live capture through a registered backend (io.capture)
        from xmaps.io.capture import LiveEventsIterator, open_capture

        session = open_capture(
            capture or "",
            bias_file=bias,
            camera_width=params.camera_width,
            camera_height=params.camera_height,
            projector_width=params.projector_width,
            projector_height=params.projector_height,
            projector_fps=params.projector_fps,
            calib_yaml=params.calib,
            # live semantics: stream until the user quits (Q / SIGINT),
            # like a physical camera -- not one pass of the synthetic loop
            duration_s=float("inf"),
        )
        mv_iterator = LiveEventsIterator(session, delta_t=delta_t)
    cam_height_reader, cam_width_reader = mv_iterator.get_size()

    assert cam_height_reader == params.camera_height, (
        f"stream geometry {cam_height_reader} != {params.camera_height}"
    )
    assert cam_width_reader == params.camera_width

    for evs in mv_iterator:
        with ev_processor.stats_printer.measure_time("main loop"):
            if not len(evs):
                continue
            ev_processor.process_events(evs)
            if ev_processor.should_close():
                sys.exit(0)


def _existing_path(path: str) -> str:
    import os

    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="xmaps-depth",
        description="Live/replay structured-light depth from an event "
        "camera and a scanning laser projector.",
    )
    ap.add_argument("--projector-width", default=720, type=int, help="Scanning-projector horizontal resolution [px]")
    ap.add_argument("--projector-height", default=1280, type=int, help="Scanning-projector vertical resolution [px]")
    ap.add_argument("--projector-fps", default=60, type=int, help="Projector refresh rate [Hz]; sets the frame segmentation period")
    ap.add_argument(
        "--projector-time-map",
        default=None,
        help="Precalibrated rectified projector time map (.npy). Without it, the "
        "ideal linear scan pattern is synthesized and rectified at startup.",
    )
    ap.add_argument("--z-near", default=0.1, type=float, help="Near clip [m] of the depth colormap")
    ap.add_argument("--z-far", default=1.0, type=float, help="Far clip [m] of the depth colormap")
    ap.add_argument(
        "--calib",
        type=_existing_path,
        required=True,
        help="OpenCV-style YAML with the stereo (camera+projector) calibration; both the X-maps and ESL dialects load",
    )
    ap.add_argument("--bias", default=None, help="Sensor .bias settings file, programmed into the camera for live capture (unused for file replay)")
    ap.add_argument(
        "--input",
        type=_existing_path,
        default=None,
        help="Prerecorded event stream to replay: EVT2/EVT3 .raw, .dat, or "
        "structured .npy. Omit to capture live through a backend (--capture).",
    )
    ap.add_argument(
        "--capture",
        default=None,
        help="Live-capture backend as 'name' or 'name:serial' (io.capture "
        "registry; 'synthetic' is built in). Used when --input is omitted.",
    )
    ap.add_argument("--loop-input", action="store_true", help="Restart the replay from the top when the file ends")
    ap.add_argument(
        "--no-frame-dropping",
        action="store_true",
        help="Disable the timing watchdog: never skip a frame of events to catch up with the stream",
    )
    ap.add_argument(
        "--camera-perspective",
        action="store_true",
        help="Render depth on the raw 640x480 camera grid instead of the default "
        "projector-view reprojection (the SAR use case).",
    )
    ap.add_argument(
        "--window",
        default="none",
        choices=["none", "files", "cv2"],
        help="Display sink: none (headless), files (PNG dumps), cv2 (GUI window).",
    )
    ap.add_argument("--out-dir", default="frames_out", help="Directory for --window files")
    ap.add_argument("--camera-width", default=640, type=int)
    ap.add_argument("--camera-height", default=480, type=int)
    ap.add_argument(
        "--low-latency",
        action="store_true",
        help="Flush every depth frame synchronously instead of keeping one "
        "frame in flight: minimum display latency, lower throughput.",
    )
    ap.add_argument(
        "--profile-dir",
        default=None,
        help="Capture a jax.profiler device trace of the replay into this "
        "directory (view with TensorBoard / xprof)",
    )
    return ap


def main(argv=None):
    from xmaps.utils.cache import enable_compile_cache

    args = vars(build_parser().parse_args(argv))
    enable_compile_cache()
    bias = args.pop("bias")
    input = args.pop("input")
    capture = args.pop("capture")
    loop_input = args.pop("loop_input")
    window = args.pop("window")
    out_dir = args.pop("out_dir")
    profile_dir = args.pop("profile_dir")
    low_latency = args.pop("low_latency")
    params = RuntimeParams(**args)

    delta_t = 1e6 / params.projector_fps / EV_PACKETS_PER_FRAME
    print(
        f"Using delta_t={delta_t:.2f} us to process "
        f"{EV_PACKETS_PER_FRAME} ev packets per projector frame."
    )

    import contextlib

    if profile_dir is not None:
        import jax

        trace_cm = jax.profiler.trace(profile_dir)
    else:
        trace_cm = contextlib.nullcontext()

    with DepthReprojectionProcessor(
        params=params, window_kind=window, out_dir=out_dir,
        low_latency=low_latency,
    ) as ev_processor, trace_cm:
        while True:
            project_events(bias, input, capture, params, delta_t, ev_processor)
            if loop_input and input:
                ev_processor.reset()
            else:
                break


if __name__ == "__main__":
    main()
