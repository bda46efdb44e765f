"""ESL baseline (init + refined) for the offline evaluation, on device.

Re-implements the reference's vendored ESL pipeline
(eval/compute_depth_esl.py, from uzh-rpg/ESL) as dense JAX programs whose
outputs play the same roles (esl/depth_init and the refined
esl/depth_optim_filtered pseudo-ground-truth consumed by the evaluation
table, SURVEY.md §4):

- ``disparity_init`` (reference :72-85): per nonzero rectified camera
  pixel, a row-wise nearest-time search over columns [c+5, c+900).
  Rebuilt as a shift-scan over the dense rectified images: one
  lax.fori_loop over the disparity range, pure elementwise ops, no
  per-pixel Python.
- ``depth_optimization`` (reference :104-129): per-pixel bounded scalar
  minimization of a patch L2 cost between the camera time image and the
  projector time surface at the reprojected location.  The projector time
  surface is an analytic column-major ramp (reference :96-101), so the
  patch cost collapses to a closed quadratic in the projected scan time:
  three (2w+1)^2 stencil sums of the camera image are precomputed once and
  every cost evaluation becomes elementwise math -- no gathers.  scipy's
  bounded Brent is replaced by a bounded two-level grid search over the
  same per-pixel bounds depth +- depth^2/P[0,3] (reference :110-112),
  evaluated for ALL pixels simultaneously (the cost is piecewise-constant
  in depth, which defeats Brent/golden-section schemes).
- bilateral + split-Bregman TV denoise (reference :242-247) via
  utils.denoise.

Method-level equivalent rather than bit-exact: argmin tie handling matches
(first minimum wins) but float32 device math vs float64 NumPy, and
golden-section vs Brent, can settle on neighboring minima.  That is the
right contract for a pseudo-GT baseline; the evaluation table compares all
methods against the same GT.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import time

import numpy as np

MIN_DISP = 5  # reference eval/compute_depth_esl.py:75
MAX_DISP = 900
OOB_COST = 1.0e10  # dominates any in-bounds quadratic cost (reference: 100000)


@functools.lru_cache(maxsize=None)
def _disparity_init_jit():
    """Module-cached jitted brute-force search (a fresh jit per call would
    re-trace the 895-step loop for every scan)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("lo", "hi"))
    def run(cam, proj, lo, hi):
        H, W = cam.shape
        proj_pad = jnp.concatenate(
            [proj, jnp.zeros((H, hi), proj.dtype)], axis=1
        )

        def body(d, state):
            count, best_cost, best_d = state
            shifted = jax.lax.dynamic_slice(proj_pad, (0, d), (H, W))
            valid = shifted != 0
            cost = (shifted - cam) ** 2
            better = valid & (cost < best_cost)
            return (
                count + valid.astype(jnp.int32),
                jnp.where(better, cost, best_cost),
                jnp.where(better, d, best_d),
            )

        init = (
            jnp.zeros((H, W), jnp.int32),
            jnp.full((H, W), jnp.inf, cam.dtype),
            jnp.zeros((H, W), jnp.int32),
        )
        count, _, best_d = jax.lax.fori_loop(lo, hi, body, init)
        ok = (cam != 0) & (count > 1)
        return jnp.where(ok, best_d, 0).astype(jnp.float32)

    return run


def disparity_init_dense(cam_rect, proj_rect, min_disp=MIN_DISP, max_disp=MAX_DISP):
    """Row-wise nearest-time disparity search (reference :72-85), dense.

    For each pixel c of each row, among nonzero projector pixels at
    columns c+d, d in [min_disp, max_disp), pick the d minimizing
    (proj - cam)^2 (first minimum on ties, like np.argmin); require at
    least two nonzero candidates and a nonzero camera pixel.
    """
    import jax.numpy as jnp

    return _disparity_init_jit()(
        jnp.asarray(cam_rect, jnp.float32),
        jnp.asarray(proj_rect, jnp.float32),
        int(min_disp),
        int(max_disp),
    )


class RefinePlan:
    """Per-pixel statics for the analytic refinement cost.

    cost^2(rho) = C0 - 2 * a(rho) * S1 + K * a(rho)^2       (in-bounds)
    where a = (trunc(x_proj) * Hp + trunc(y_proj)) / (Wp * Hp) is the
    projector scan time at the reprojected pixel and C0/S1 are stencil
    sums of the camera image (see module docstring).
    """

    def __init__(self, calib_params, maps, window_size: int, proj_w: int, proj_h: int):
        from xmaps.calib.geometry import undistort_points

        cam_K = calib_params.camera_K
        cam_D = calib_params.camera_D
        H, W = calib_params.camera_height, calib_params.camera_width
        xs, ys = np.meshgrid(np.arange(W), np.arange(H))
        pts = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
        # reference :29-34: undistortPoints(P=cam_K), then normalize by K
        und = undistort_points(pts, cam_K, cam_D, R=None, P=cam_K)
        self.x_n = (
            (und[:, 0] - cam_K[0, 2]) / cam_K[0, 0]
        ).reshape(H, W).astype(np.float32)
        self.y_n = (
            (und[:, 1] - cam_K[1, 2]) / cam_K[1, 1]
        ).reshape(H, W).astype(np.float32)
        self.R = np.asarray(maps.calib.cam2proj_R, np.float32)
        self.T = np.asarray(maps.calib.cam2proj_T, np.float32).reshape(3)
        self.proj_K = np.asarray(calib_params.projector_K, np.float32)
        self.proj_D = np.asarray(calib_params.projector_D, np.float32)
        self.window_size = int(window_size)
        self.w = self.window_size // 2
        self.proj_w = int(proj_w)
        self.proj_h = int(proj_h)
        self.p03 = float(maps.P2[0, 3])
        # per-iters traced refinement programs (see depth_optimization_dense)
        self._jit_cache = {}


def depth_optimization_dense(depth_init, cam_image, plan: RefinePlan, iters: int = 64):
    """Refinement of every defined depth pixel at once (reference
    depth_optimization, :104-129).  The traced program is cached on the
    plan (re-tracing the search loop per scan costs seconds).

    The cost is piecewise-constant in depth (integer projector pixel
    casts), which defeats gradient/golden-section schemes, so the bounded
    minimization is a two-level dense grid search: ``iters`` samples over
    [depth - diff, depth + diff], then ``iters`` more within one coarse
    step of the best sample.  First minimum wins (np.argmin semantics);
    the initial depth is always among the samples, so the result never has
    a higher cost than the init."""
    import jax

    fn = plan._jit_cache.get(iters)
    if fn is None:
        fn = plan._jit_cache[iters] = jax.jit(
            functools.partial(_depth_optimization_impl, plan=plan, iters=iters)
        )
    return fn(depth_init, cam_image)


def _depth_optimization_impl(depth_init, cam_image, *, plan, iters):
    import jax
    import jax.numpy as jnp

    w = plan.w
    ws = plan.window_size
    Hp, Wp = plan.proj_h, plan.proj_w
    K = (2 * w + 1) ** 2
    inv_n = 1.0 / (Wp * Hp)

    # stencil sums of the camera image (computed once per scan)
    cam = jnp.asarray(cam_image, jnp.float32)
    H, W = cam.shape
    pad = jnp.pad(cam, w)  # zero pad; border pixels are masked out below
    S0 = jnp.zeros_like(cam)
    S1 = jnp.zeros_like(cam)
    X1 = jnp.zeros_like(cam)
    B2 = 0.0
    for dy in range(-w, w + 1):
        for dx in range(-w, w + 1):
            c = pad[w + dy : w + dy + H, w + dx : w + dx + W]
            b = (dx * Hp + dy) * inv_n
            S0 = S0 + c * c
            S1 = S1 + c
            X1 = X1 + c * b
            B2 += b * b

    xn = jnp.asarray(plan.x_n)
    yn = jnp.asarray(plan.y_n)
    R = jnp.asarray(plan.R)
    T = jnp.asarray(plan.T)
    pK = jnp.asarray(plan.proj_K)
    k1, k2, p1, p2, k3 = [float(v) for v in np.resize(plan.proj_D, 5)]

    def cost(rho):
        # project_and_backproject_punkt (reference :27-42), elementwise
        X = xn * rho
        Y = yn * rho
        Z = rho
        xp = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + T[0]
        yp = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + T[1]
        zp = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + T[2]
        zp = jnp.where(zp == 0, 1e-12, zp)
        u = xp / zp
        v = yp / zp
        r2 = u * u + v * v
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        ud = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        vd = v * radial + p1 * (r2 + 2 * v * v) + 2 * p2 * u * v
        px = pK[0, 0] * ud + pK[0, 2]
        py = pK[1, 1] * vd + pK[1, 2]
        xi = px.astype(jnp.int32)  # trunc toward zero (reference :50 int cast)
        yi = py.astype(jnp.int32)
        inb = (
            (yi - w > 0) & (yi + w < Hp) & (xi - w > 0) & (xi + w < Wp)
        )  # reference :54-59 (strict)
        a = (xi * Hp + yi).astype(jnp.float32) * inv_n
        quad = (S0 - 2.0 * X1 + B2) - 2.0 * a * S1 + K * a * a
        return jnp.where(inb, quad, OOB_COST)

    depth0 = jnp.asarray(depth_init, jnp.float32)
    diff = (depth0 * depth0) / plan.p03  # reference :110 bound radius

    lo0 = depth0 - diff
    hi0 = depth0 + diff

    def grid_minimize(center, radius, n):
        # n+1 evenly spaced samples, clamped to the reference's bounds;
        # center is sampled exactly at i = n/2 (n even)
        step = 2.0 * radius / n

        def body(i, state):
            best_cost, best_x = state
            x = jnp.clip(center - radius + i * step, lo0, hi0)
            f = cost(x)
            better = f < best_cost
            return (
                jnp.where(better, f, best_cost),
                jnp.where(better, x, best_x),
            )

        init = (jnp.full_like(center, jnp.inf), center)
        best_cost, best_x = jax.lax.fori_loop(0, n + 1, body, init)
        return best_x, step

    x1, step1 = grid_minimize(depth0, diff, iters)
    refined, _ = grid_minimize(x1, step1, iters)

    # reference :107-108: only pixels with depth > 0, at least window_size
    # away from every border, are optimized; the rest stay 0.
    ys, xs = jnp.meshgrid(jnp.arange(H), jnp.arange(W), indexing="ij")
    in_region = (
        (ys >= ws) & (ys < H - ws) & (xs >= ws) & (xs < W - ws)
    )
    return jnp.where((depth0 > 0) & in_region, refined, 0.0)


def normalize_scan(cam_image: np.ndarray) -> np.ndarray:
    """Reference :205-209: normalize nonzero values to [0, 1], clamp
    negatives (i.e. former zeros) to 0."""
    nz = cam_image != 0
    lo = cam_image[nz].min()
    hi = cam_image[nz].max()
    out = (cam_image - lo) / (hi - lo)
    out[out < 0] = 0
    return out.astype(np.float32)


def main(argv=None):
    from xmaps.utils.cache import cache_dir, enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="ESL depth baseline (init + refined) on the JAX device"
    )
    parser.add_argument("-object_dir", type=str, default="")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="")
    parser.add_argument("-w", type=int, default=3, help="Window size")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    parser.add_argument(
        "-skip_refine", action="store_true",
        help="Only compute depth_init (skip optimization + denoise)",
    )
    args = parser.parse_args(argv)

    import jax

    from xmaps.calib.maps import (
        CalibrationParams,
        CamProjMaps,
        remap_nearest,
    )
    from xmaps.utils.denoise import bilateral_filter, tv_denoise_split_bregman

    esl_dir = os.path.join(args.object_dir, "esl")
    dirs = {
        name: os.path.join(esl_dir, name)
        for name in ("disparity_init", "depth_init", "depth_optim", "depth_optim_filtered")
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
        rectification_scale=3.0,
    )
    maps = CamProjMaps.build_cached(
        calib, zero_undistort_proj_map=True,
        cache_dir=cache_dir("tables"),
    )

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print(f"No camera files found in {args.object_dir}/scans_np/!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    # analytic projector ramp rectified into the rectified frame
    # (reference :96-101 + :201)
    proj_rect = maps.build_rectified_time_map(
        scan_upwards=False, border_replicate=False
    )
    plan = RefinePlan(calib, maps, args.w, args.proj_width, args.proj_height)
    p03 = float(maps.P2[0, 3])

    for i in range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))):
        cam_raw = np.load(scan_files[i])
        if np.count_nonzero(cam_raw) == 0:
            print(f"Skip camera npy file {scan_files[i]} since it is empty")
            continue
        print(f"Processing frame: {i}, camera npy file {scan_files[i]}")
        cam_norm = normalize_scan(cam_raw)

        t0 = time.time()
        cam_rect = remap_nearest(
            cam_norm, maps.camera_mapx, maps.camera_mapy,
            border_replicate=False,
        )
        disparity_rect = np.asarray(
            jax.device_get(disparity_init_dense(cam_rect, proj_rect))
        )
        # rectified -> camera view (reference :218-222)
        disparity = remap_nearest(
            disparity_rect,
            maps.disp_cam_mapx_f32,
            maps.disp_cam_mapy_f32,
            border_replicate=False,
        ).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            depth_init = np.where(
                disparity != 0, p03 / disparity, 0.0
            ).astype(np.float32)
        depth_init = np.asarray(depth_init, np.float32)
        np.save(
            os.path.join(dirs["disparity_init"], f"scans{str(i).zfill(3)}.npy"),
            np.asarray(disparity, np.float32),
        )
        print(f"Completed depth initialization: {i} in time {time.time() - t0}")
        np.save(
            os.path.join(dirs["depth_init"], f"scans{str(i).zfill(3)}.npy"),
            depth_init,
        )

        if args.skip_refine:
            continue

        # reference :211: zeros of the unrectified image -> 1/img[0,0]
        cam_for_refine = cam_norm.copy()
        with np.errstate(divide="ignore"):
            fill = 1.0 / cam_norm[0, 0] if cam_norm[0, 0] != 0 else np.inf
        cam_for_refine[cam_for_refine == 0] = fill

        t0 = time.time()
        depth_optim = np.asarray(
            jax.device_get(
                depth_optimization_dense(depth_init, cam_for_refine, plan)
            )
        ).astype(np.float32)
        print(f"Completed depth refinement: {i} in time {time.time() - t0}")
        np.save(
            os.path.join(dirs["depth_optim"], f"scans{str(i).zfill(3)}.npy"),
            depth_optim,
        )

        t0 = time.time()
        filtered = bilateral_filter(depth_optim, d=5, sigma_color=3.0, sigma_space=3.0)
        filtered = tv_denoise_split_bregman(filtered, mu=0.5)
        filtered = np.asarray(jax.device_get(filtered)).astype(np.float32)
        print(
            f"Completed bilateral filter and denoising: {i} in time {time.time() - t0}"
        )
        np.save(
            os.path.join(dirs["depth_optim_filtered"], f"scans{str(i).zfill(3)}.npy"),
            filtered,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
