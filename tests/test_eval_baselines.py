"""Tests for the ESL / MC3D baseline re-implementations and denoise filters.

Oracles are direct NumPy transcriptions of the reference formulas
(eval/compute_depth_esl.py:72-85, eval/mc3d_baseline.py:40-78), run on
small synthetic inputs.
"""

import numpy as np
import pytest

from xmaps.apps.eval_esl import (
    RefinePlan,
    depth_optimization_dense,
    disparity_init_dense,
    normalize_scan,
)
from xmaps.apps.eval_mc3d import build_mc3d_tables, mc3d_disparity_dense
from xmaps.calib.maps import CamProjMaps
from xmaps.utils.denoise import (
    bilateral_filter,
    median_blur_3x3,
    tv_denoise_split_bregman,
)
from xmaps.utils.synthetic import make_synthetic_calibration


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


# ---------------------------------------------------------------------------
# disparity_init


def oracle_disparity_init(cam, proj, min_disp=5, max_disp=900):
    """Transcription of reference eval/compute_depth_esl.py:72-85."""
    disparity = np.zeros(cam.shape)
    r, c = np.where(cam > 0)
    for i in range(len(r)):
        nz = np.nonzero(proj[r[i], c[i] + min_disp : c[i] + max_disp])[0]
        patches = proj[r[i], c[i] + min_disp + nz]
        if len(nz) > 1:
            cost = (patches - cam[r[i], c[i]]) ** 2
            c_proj = c[i] + min_disp + nz[np.argmin(cost)]
            if (c_proj - c[i]) < max_disp:
                disparity[r[i], c[i]] = abs(c_proj - c[i])
    return disparity.astype(np.float32)


def test_disparity_init_matches_oracle(rng):
    H, W = 24, 160
    cam = np.zeros((H, W), np.float32)
    proj = np.zeros((H, W), np.float32)
    # sparse nonzero values in (0, 1]
    cam_mask = rng.random((H, W)) < 0.15
    proj_mask = rng.random((H, W)) < 0.25
    cam[cam_mask] = rng.random(cam_mask.sum()).astype(np.float32) + 1e-3
    proj[proj_mask] = rng.random(proj_mask.sum()).astype(np.float32) + 1e-3

    got = np.asarray(disparity_init_dense(cam, proj, min_disp=5, max_disp=60))
    want = oracle_disparity_init(cam, proj, min_disp=5, max_disp=60)
    np.testing.assert_array_equal(got, want)


def _search_case(rng, trial):
    """One monotone-row scan case (the inputs of the former binary-search
    kernel's tests): sorted projector rows, plateaus on odd trials, and
    exact camera/projector value matches that exercise the tie rules."""
    H, W = 24, 300 + 80 * trial
    base = np.sort(rng.random((H, W)).astype(np.float32), axis=1)
    if trial % 2:
        base = np.round(base * 60) / 60  # equal-value plateaus
    mask = rng.random((H, W)) < (0.15 + 0.1 * trial)
    proj = np.where(mask, base + 1e-3, 0).astype(np.float32)
    cam = np.where(
        rng.random((H, W)) < 0.3, rng.random((H, W)), 0
    ).astype(np.float32)
    cc = rng.integers(0, W - 130, 40)
    rr = rng.integers(0, H, 40)
    cam[rr, cc] = proj[rr, np.minimum(cc + 17, W - 1)]
    return cam, proj, 120 + 60 * trial


@pytest.mark.parametrize("trial", range(3))
def test_disparity_init_matches_oracle_monotone_rows(trial):
    """The dense brute force on rectified-ramp-like rows (monotone, with
    plateaus and exact ties) against the reference transcription."""
    rng = np.random.default_rng(7)
    for k in range(trial + 1):  # replay the seed-7 stream up to this trial
        cam, proj, md = _search_case(rng, k)
    got = np.asarray(disparity_init_dense(cam, proj, min_disp=5, max_disp=md))
    want = oracle_disparity_init(cam, proj, min_disp=5, max_disp=md)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_disparity_init_requires_two_candidates():
    cam = np.zeros((2, 40), np.float32)
    proj = np.zeros((2, 40), np.float32)
    cam[0, 2] = 0.5
    proj[0, 10] = 0.5  # single candidate -> rejected
    cam[1, 2] = 0.5
    proj[1, 10] = 0.49
    proj[1, 20] = 0.9  # two candidates -> closest-value one wins
    got = np.asarray(disparity_init_dense(cam, proj, min_disp=5, max_disp=30))
    assert got[0, 2] == 0.0
    assert got[1, 2] == 8.0  # d = 10 - 2


# ---------------------------------------------------------------------------
# depth refinement


def _refine_rig():
    calib = make_synthetic_calibration(
        camera_width=64,
        camera_height=48,
        projector_width=40,
        projector_height=64,
        baseline=3.0,  # cm-like scale: p03 ~ 220, bounds z^2/p03 stay tight
    )
    maps = CamProjMaps(calib)
    Wp, Hp = calib.projector_width, calib.projector_height
    plan = RefinePlan(calib, maps, window_size=3, proj_w=Wp, proj_h=Hp)
    return calib, maps, plan


def _project_int(plan, rho, H, W):
    """The reference's project_and_backproject + int cast, NumPy."""
    X = plan.x_n * rho
    Y = plan.y_n * rho
    Z = np.broadcast_to(rho, (H, W))
    R, T = plan.R, plan.T
    xp = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + T[0]
    yp = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + T[1]
    zp = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + T[2]
    u, v = xp / zp, yp / zp
    px = plan.proj_K[0, 0] * u + plan.proj_K[0, 2]
    py = plan.proj_K[1, 1] * v + plan.proj_K[1, 2]
    return px.astype(np.int32), py.astype(np.int32)


def test_refinement_quad_equals_patch_cost(rng):
    """The closed-form quadratic inside depth_optimization_dense must equal
    the literal reference patch cost^2 (compute_depth_esl.py:45-69) for the
    analytic projector ramp."""
    calib, maps, plan = _refine_rig()
    Wp, Hp = calib.projector_width, calib.projector_height
    H, W = calib.camera_height, calib.camera_width
    cam_img = rng.random((H, W)).astype(np.float32)
    proj_ramp = np.fromfunction(
        lambda y, x: (x * Hp + y) / (Wp * Hp), (Hp, Wp)
    ).astype(np.float32)

    w, K = 1, 9
    inv_n = 1.0 / (Wp * Hp)
    pad = np.pad(cam_img, w)
    S0 = np.zeros((H, W))
    S1 = np.zeros((H, W))
    X1 = np.zeros((H, W))
    B2 = 0.0
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            c = pad[w + dy : w + dy + H, w + dx : w + dx + W]
            b = (dx * Hp + dy) * inv_n
            S0 += c * c
            S1 += c
            X1 += c * b
            B2 += b * b

    for _ in range(100):
        yy = int(rng.integers(w + 1, H - w - 1))
        xx = int(rng.integers(w + 1, W - w - 1))
        x_p = int(rng.integers(w + 1, Wp - w - 1))
        y_p = int(rng.integers(w + 1, Hp - w - 1))
        pp = proj_ramp[y_p - w : y_p + w + 1, x_p - w : x_p + w + 1]
        ep = cam_img[yy - w : yy + w + 1, xx - w : xx + w + 1]
        ref = np.sum((ep - pp) ** 2)
        a = (x_p * Hp + y_p) * inv_n
        quad = (S0[yy, xx] - 2 * X1[yy, xx] + B2) - 2 * a * S1[yy, xx] + K * a * a
        assert abs(ref - quad) < 1e-5


def test_depth_optimization_does_not_worsen_cost():
    """Golden-section refinement must end at a reference-cost no worse than
    the init's (the cost is plateau-piecewise-constant in depth, so exact
    depth recovery is bounded by the plateau width -- same as the
    reference's Brent)."""
    calib, maps, plan = _refine_rig()
    Wp, Hp = calib.projector_width, calib.projector_height
    H, W = calib.camera_height, calib.camera_width

    z_true = 20.0
    rho = np.full((H, W), z_true, np.float32)
    xi, yi = _project_int(plan, rho, H, W)
    inb = (yi > 1) & (yi < Hp - 1) & (xi > 1) & (xi < Wp - 1)
    cam_img = np.where(inb, (xi * Hp + yi) / float(Wp * Hp), 0.0).astype(
        np.float32
    )
    depth_init = np.where(inb, np.float32(z_true * 1.05), 0.0).astype(np.float32)
    refined = np.asarray(
        depth_optimization_dense(depth_init, cam_img, plan, iters=50)
    )
    sel = (refined > 0) & inb
    assert sel.sum() > 500

    proj_ramp = np.fromfunction(
        lambda y, x: (x * Hp + y) / (Wp * Hp), (Hp, Wp)
    ).astype(np.float32)
    w = 1

    def patch_cost(depth):
        xi, yi = _project_int(plan, depth, H, W)
        ok = (yi - w > 0) & (yi + w < Hp) & (xi - w > 0) & (xi + w < Wp)
        cost = np.full((H, W), 1e5, np.float32)
        ys, xs = np.where(sel & ok)
        for y, x in zip(ys, xs):
            pp = proj_ramp[yi[y, x] - w : yi[y, x] + w + 1, xi[y, x] - w : xi[y, x] + w + 1]
            ep = cam_img[y - w : y + w + 1, x - w : x + w + 1]
            cost[y, x] = np.sum((ep - pp) ** 2)
        return cost

    c_init = patch_cost(depth_init)
    c_ref = patch_cost(refined)
    # the init depth is among the grid samples, so cost can never worsen
    worse = (c_ref[sel] > c_init[sel] + 1e-5).mean()
    assert worse == 0.0, f"refinement worsened cost on {worse:.1%} of pixels"
    # and strictly improves a solid share (init is off the min plateau)
    assert (c_ref[sel] < c_init[sel] - 1e-9).mean() > 0.3
    # stays within the reference's search bounds
    bound = (depth_init**2) / plan.p03
    assert (refined[sel] >= depth_init[sel] - bound[sel] - 1e-3).all()
    assert (refined[sel] <= depth_init[sel] + bound[sel] + 1e-3).all()


def test_normalize_scan():
    img = np.array([[0.0, 0.2], [0.6, 1.0]], np.float32)
    out = normalize_scan(img)
    assert out[0, 0] == 0.0  # former zero clamps to 0
    assert out[0, 1] == 0.0  # min nonzero -> 0
    assert out[1, 1] == 1.0


# ---------------------------------------------------------------------------
# MC3D


def oracle_mc3d(cam_image, xc, yc, PX, PY, proj_w, proj_h, rect_w3, rect_h3):
    """Transcription of reference eval/mc3d_baseline.py:40-78 (window
    search done brute force)."""
    nc = proj_h // 15
    disparity = np.zeros(cam_image.shape, np.float32)
    for i in range(cam_image.shape[0]):
        for j in range(cam_image.shape[1]):
            t = cam_image[i, j]
            if t <= 0:
                continue
            xcu, ycu = xc[i, j], yc[i, j]
            if not (0 < xcu < rect_w3 and 0 < ycu < rect_h3):
                continue
            pid = int(proj_w * proj_h * t)
            if pid >= proj_w * proj_h:
                continue
            proj_x, proj_y = np.unravel_index(pid, (proj_w, proj_h))
            diff_y, disp = [], []
            for y in range(max(proj_y - nc, 0), min(proj_y + nc, proj_h)):
                diff_y.append(abs(ycu - PY[y, proj_x]))
                disp.append(PX[y, proj_x] - xcu)
            if diff_y and np.min(diff_y) <= 50:
                idx = int(np.argmin(diff_y))
                if disp[idx] > 0:
                    disparity[i, j] = disp[idx]
    return disparity


def test_mc3d_matches_oracle(rng):
    calib = make_synthetic_calibration(
        camera_width=48, camera_height=36, projector_width=45, projector_height=60
    )
    Wp, Hp = calib.projector_width, calib.projector_height
    tables = build_mc3d_tables(calib, Wp, Hp, calib.camera_width, calib.camera_height)
    xc, yc, PX, PY, p03, _ = tables

    cam = np.zeros((calib.camera_height, calib.camera_width), np.float32)
    mask = rng.random(cam.shape) < 0.3
    cam[mask] = rng.random(mask.sum()).astype(np.float32)

    # chunk=5 forces uneven slab boundaries (2*nc=8 -> a partial last slab)
    got = np.asarray(mc3d_disparity_dense(cam, tables, Wp, Hp, chunk=5))
    want = oracle_mc3d(cam, xc, yc, PX, PY, Wp, Hp, Wp * 3, Hp * 3)
    # the windowed-argmin sweep is EXACT vs the reference's per-pixel scan
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# denoise filters


def test_median_blur_matches_numpy(rng):
    img = rng.random((17, 23)).astype(np.float32)
    got = np.asarray(median_blur_3x3(img))
    padded = np.pad(img, 1, mode="edge")
    stack = np.stack(
        [
            padded[1 + dy : 1 + dy + 17, 1 + dx : 1 + dx + 23]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ]
    )
    want = np.median(stack, axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bilateral_preserves_edge(rng):
    img = np.zeros((32, 32), np.float32)
    img[:, 16:] = 10.0
    noisy = img + rng.normal(0, 0.3, img.shape).astype(np.float32)
    out = np.asarray(bilateral_filter(noisy, d=5, sigma_color=3.0, sigma_space=3.0))
    # noise reduced on flats...
    assert out[:, :12].std() < noisy[:, :12].std() * 0.7
    # ...edge magnitude preserved
    assert abs(out[:, 20:].mean() - out[:, :12].mean()) > 9.0


def test_tv_denoise_smooths(rng):
    img = np.zeros((24, 24), np.float32)
    img[8:16, 8:16] = 5.0
    noisy = img + rng.normal(0, 0.5, img.shape).astype(np.float32)
    out = np.asarray(tv_denoise_split_bregman(noisy, mu=0.5))

    def tv(a):
        return np.abs(np.diff(a, axis=0)).sum() + np.abs(np.diff(a, axis=1)).sum()

    assert tv(out) < tv(noisy) * 0.7
    assert np.abs(out - img).mean() < np.abs(noisy - img).mean() + 0.1
