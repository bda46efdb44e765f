"""Smoke tests for the eval/ measurement tooling.

The measurement scripts (geometry bench, stage tracer) are run on the
GPU by hand, so nothing else exercises them in CI; these subprocess
smokes keep them importable, runnable end-to-end on CPU where they can
be, and emitting their one-line JSON contract.  They check FLOW, not
numbers -- CPU timings are meaningless.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_json(args, timeout=540):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # the virtual 8-device mesh is pointless here and slows compiles
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable] + args, cwd=REPO, env=env, timeout=timeout,
        capture_output=True, text=True,
    )
    assert out.returncode == 0, f"{args}:\n{out.stdout}\n{out.stderr}"
    last = out.stdout.strip().splitlines()[-1]
    return json.loads(last)


def test_bench_geometry_smoke():
    res = _run_json([
        "eval/bench_geometry.py", "--geometry", "demo", "--frames", "2",
        "--events", "4096", "--rounds", "1", "3",
    ])
    assert res["geometry"] == "demo"
    assert res["frame_ms"] > 0
    assert res["events_per_frame"] > 0
    assert res["rect"] == [1320, 1760]


@pytest.mark.parametrize("camera_perspective", [False, True])
def test_bench_geometry_unsorted_smoke(camera_perspective):
    """Arrival-order staging (scatter-max) runs in both views and reports
    what it ran."""
    res = _run_json([
        "eval/bench_geometry.py", "--geometry", "demo", "--frames", "1",
        "--events", "2048", "--rounds", "1", "2", "--unsorted",
        *(["--camera-perspective"] if camera_perspective else []),
    ])
    assert res["scatter"] == "max"
    assert res["frame_ms"] > 0 and res["events_per_frame"] > 0


def test_stage_trace_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "eval/stage_trace.py", "--geometry", "demo"],
        cwd=REPO, env=env, timeout=300, capture_output=True, text=True,
    )
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
