"""Offline eval harness tests: metrics formulas, PLY IO, end-to-end eval
app on synthetic time-surface scans."""

import os

import numpy as np
import pytest

from xmaps.utils.eval_metrics import (
    combine_depths,
    evaluation_stats,
    load_and_filter,
)
from xmaps.utils.ply import read_ply, write_ply


def _reference_stats(estimate, groundtruth):
    """Direct transcription of reference create_evaluation_table.py:14-54
    as an independent cross-check."""
    margin = 0.01 * np.sum(groundtruth[groundtruth > 0]) / (np.sum(groundtruth > 0))
    diff = np.abs(groundtruth - estimate)
    diff[groundtruth == 0] = 0
    fillrate = (np.sum(diff < margin) - np.sum(groundtruth == 0)) / (
        diff.shape[0] * diff.shape[1] - np.sum(groundtruth == 0)
    )
    diff_sq = pow((groundtruth - estimate), 2)
    valid = (groundtruth > 0) & (estimate > 0)
    rmse = np.sqrt(np.sum(diff_sq[valid]) / np.sum(valid)) if np.sum(valid) > 0 else 0
    diff_abs = np.abs(groundtruth - estimate)
    diff_abs[groundtruth == 0] = 0
    npx = diff_abs.shape[0] * diff_abs.shape[1]
    return (
        fillrate,
        rmse,
        100 * np.sum(diff_abs > 1) / npx,
        100 * np.sum(diff_abs > 5) / npx,
        100 * np.sum(diff_abs > 10) / npx,
    )


def test_metrics_match_reference_formulas(rng):
    gt = rng.random((60, 80)) * 100
    gt[gt < 30] = 0
    est = gt + rng.normal(0, 2, gt.shape)
    est[rng.random(gt.shape) < 0.2] = 0
    s = evaluation_stats(est, gt)
    fr, rmse, p1, p5, p10 = _reference_stats(est, gt)
    assert np.isclose(s.fillrate, fr)
    assert np.isclose(s.rmse, rmse)
    assert np.isclose(s.perc_1, p1)
    assert np.isclose(s.perc_5, p5)
    assert np.isclose(s.perc_10, p10)


def test_load_and_filter(rng):
    d = rng.random((10, 10)) * 200
    gt = rng.random((10, 10)) * 200
    gt[0, :] = 0
    out = load_and_filter(d, gt, 20, 120)
    assert (out[0, :] == 0).all()
    assert not ((out > 0) & ((out <= 20) | (out >= 120))).any()


def test_combine_depths():
    a = np.array([[50.0, 0.0], [30.0, 0.0]])
    b = np.array([[70.0, 40.0], [0.0, 0.0]])
    combined, avg = combine_depths([a, b], 20, 120)
    # per-pixel mean [[60, 40], [30, 0]], then the reference's 3x3 median
    # blur (esl_utilities.py combine_mc3d:172) with edge replication
    np.testing.assert_allclose(combined, [[40.0, 40.0], [30.0, 30.0]])
    assert np.isclose(avg, np.mean([40.0, 40.0, 30.0, 30.0]))


def test_ply_roundtrip(tmp_path, rng):
    pts = rng.random((100, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    write_ply(path, pts)
    back = read_ply(path)
    np.testing.assert_array_equal(back, pts)


def _write_esl_yaml(path, calib):
    """Write an ESL FileStorage-dialect yaml from CalibrationParams."""
    def mat(name, m):
        m = np.asarray(m, dtype=np.float64)
        data = ", ".join(repr(float(v)) for v in m.ravel())
        return (
            f"{name}: !!opencv-matrix\n"
            f"   rows: {m.shape[0]}\n"
            f"   cols: {m.shape[1] if m.ndim > 1 else 1}\n"
            f"   dt: d\n"
            f"   data: [ {data} ]\n"
        )

    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(mat("cam_K", calib.camera_K))
        f.write(mat("cam_kc", calib.camera_D.reshape(1, -1)))
        f.write(mat("proj_K", calib.projector_K))
        f.write(mat("proj_kc", calib.projector_D.reshape(1, -1)))
        f.write(mat("R", calib.cam2proj_R))
        f.write(mat("T", calib.cam2proj_T))


def test_eval_app_end_to_end(tmp_path):
    """Synthetic scans -> eval_xmaps -> depth npy + ply; recovered depth
    must match the simulated plane depth (the offline analog of the
    reference's ESL evaluation, SURVEY.md §3.2)."""
    from xmaps.apps.eval_xmaps import main as eval_main
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    # camera oversamples the projector so the per-pixel time surface keeps
    # most correspondences (the ESL scans' regime)
    calib = make_synthetic_calibration(
        camera_width=96, camera_height=72, projector_width=45, projector_height=80
    )
    yaml_path = str(tmp_path / "calib.yaml")
    _write_esl_yaml(yaml_path, calib)

    scans = tmp_path / "scans_np"
    scans.mkdir()
    z_true = [0.5, 0.7]
    for i, z in enumerate(z_true):
        ev = simulate_plane_events(calib, depth_m=z, scan_upwards=False)
        img = np.zeros((calib.camera_height, calib.camera_width), np.float64)
        # time-surface: latest event time per pixel, scaled to (0,1]
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        np.save(scans / f"scan{i:03d}.npy", img)

    rc = eval_main(
        [
            "-object_dir", str(tmp_path),
            "-proj_height", str(calib.projector_height),
            "-proj_width", str(calib.projector_width),
            "-calib", yaml_path,
            "-num_scans", "2",
            "-cam_width", str(calib.camera_width),
            "-cam_height", str(calib.camera_height),
        ]
    )
    assert rc == 0

    for i, z in enumerate(z_true):
        depth = np.load(tmp_path / "x_maps" / "depth_init" / f"scans{i:03d}.npy")
        valid = depth > 0
        assert valid.sum() > 200
        # robust: the dominant depth mode must sit at the plane depth
        near = np.abs(depth[valid] - z) < 0.05
        assert near.mean() > 0.5, f"scan {i}: only {near.mean():.2f} within 5cm of {z}"
        pc = read_ply(str(tmp_path / "x_maps" / "pointcloud_init" / f"scans{i:03d}.ply"))
        assert len(pc) > 200
        # reference axis convention (cam_proj_calibration.py:327-329) flips
        # z, so plane depth appears as -z
        assert abs(np.median(-pc[:, 2]) - z) < 0.08


def test_eval_app_sharded_matches_single(tmp_path):
    """-devices N shards scans across the virtual CPU mesh and must write
    the same depth maps as the single-device path (the single-program
    analog of the reference's GNU-parallel fan-out, eval/x-map-eval.sh:49-66)."""
    from xmaps.apps.eval_xmaps import main as eval_main
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration(
        camera_width=96, camera_height=72, projector_width=45, projector_height=80
    )
    yaml_path = str(tmp_path / "calib.yaml")
    _write_esl_yaml(yaml_path, calib)
    scans = tmp_path / "scans_np"
    scans.mkdir()
    for i, z in enumerate([0.5, 0.6, 0.7]):
        ev = simulate_plane_events(calib, depth_m=z, scan_upwards=False)
        img = np.zeros((calib.camera_height, calib.camera_width), np.float64)
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        np.save(scans / f"scan{i:03d}.npy", img)

    common = [
        "-object_dir", str(tmp_path),
        "-proj_height", str(calib.projector_height),
        "-proj_width", str(calib.projector_width),
        "-calib", yaml_path,
        "-num_scans", "3",
        "-cam_width", str(calib.camera_width),
        "-cam_height", str(calib.camera_height),
        "-no_pointcloud",
    ]
    assert eval_main(common) == 0
    single = [
        np.load(tmp_path / "x_maps" / "depth_init" / f"scans{i:03d}.npy")
        for i in range(3)
    ]
    assert eval_main(common + ["-devices", "4"]) == 0
    for i in range(3):
        sharded = np.load(tmp_path / "x_maps" / "depth_init" / f"scans{i:03d}.npy")
        np.testing.assert_array_equal(sharded, single[i])


def test_full_eval_chain(tmp_path, capsys):
    """The complete offline evaluation chain on synthetic scans: ESL
    (init + refined GT) -> MC3D -> X-maps -> comparison table (the
    reference's eval/x-map-eval.sh flow, SURVEY.md §3.3)."""
    from xmaps.apps.eval_esl import main as esl_main
    from xmaps.apps.eval_mc3d import main as mc3d_main
    from xmaps.apps.eval_table import main as table_main
    from xmaps.apps.eval_xmaps import main as xmaps_main
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration(
        camera_width=96, camera_height=72, projector_width=45,
        projector_height=80, baseline=3.0,
    )
    seq = tmp_path / "seq1"
    scans = seq / "scans_np"
    scans.mkdir(parents=True)
    yaml_path = str(tmp_path / "calib.yaml")
    _write_esl_yaml(yaml_path, calib)
    for i, z in enumerate([30.0, 35.0]):
        ev = simulate_plane_events(calib, depth_m=z, scan_upwards=False)
        img = np.zeros((calib.camera_height, calib.camera_width), np.float64)
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        np.save(scans / f"scan{i:03d}.npy", img)

    common = [
        "-object_dir", str(seq),
        "-proj_height", str(calib.projector_height),
        "-proj_width", str(calib.projector_width),
        "-calib", yaml_path,
        "-num_scans", "2",
        "-cam_width", str(calib.camera_width),
        "-cam_height", str(calib.camera_height),
    ]
    assert esl_main(common) == 0
    assert mc3d_main(common) == 0
    assert xmaps_main(common + ["-no_pointcloud"]) == 0

    # every method recovered a plausible plane depth for scan 0 (z=30)
    for method in ("esl/depth_init", "mc3d/depth", "x_maps/depth_init"):
        d = np.load(seq / method / "scans000.npy")
        nz = d[d > 0]
        assert len(nz) > 100, method
        assert abs(np.median(nz) - 30.0) < 2.0, (method, np.median(nz))
    assert (seq / "esl/depth_optim_filtered/scans000.npy").exists()

    assert table_main(
        ["-object_dir", str(tmp_path), "-scenes", "seq1",
         "-min_depth", "5", "-max_depth", "60"]
    ) == 0
    out = capsys.readouterr().out
    for row in ("ESL (init)", "MC3D", "X-Maps (ours)"):
        assert row in out, out


def test_eval_table_app(tmp_path, rng):
    """eval_table over a synthetic directory layout prints a table line."""
    from xmaps.apps.eval_table import main as table_main

    seq = tmp_path / "seq1"
    for sub in ("esl/depth_optim_filtered", "esl/depth_init", "x_maps/depth_init", "mc3d/depth"):
        (seq / sub).mkdir(parents=True)
    gt = rng.random((48, 64)) * 80 + 25
    for k in range(3):
        np.save(seq / "esl/depth_optim_filtered" / f"f{k}.npy", gt)
        np.save(seq / "esl/depth_init" / f"f{k}.npy", gt + rng.normal(0, 0.5, gt.shape))
        np.save(seq / "x_maps/depth_init" / f"f{k}.npy", gt + rng.normal(0, 0.5, gt.shape))
        np.save(seq / "mc3d/depth" / f"f{k}.npy", gt + rng.normal(0, 2.0, gt.shape))
    rc = table_main(["-object_dir", str(tmp_path), "-scenes", "seq1"])
    assert rc == 0
