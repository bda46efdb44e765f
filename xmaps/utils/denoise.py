"""Dense image filters for the offline eval baselines (device-friendly).

Device replacements for the OpenCV / pylops filters the reference eval
stack leans on:

- 3x3 median blur             (reference: eval/mc3d_baseline.py:131,
                               eval/esl_utilities.py:172 `cv2.medianBlur`)
- bilateral filter            (reference: eval/compute_depth_esl.py:242
                               `cv2.bilateralFilter(depth, 5, 3, 3)`)
- split-Bregman TV-L2 denoise (reference: eval/esl_utilities.py:194-224
                               `pylops.optimization.sparsity.SplitBregman`)

All are pure jax.numpy stencil/iteration code -- fixed shapes, fixed
iteration counts, no data-dependent control flow -- so they fuse and run on
the VPU under jit (and equally on CPU for tests).  They are quality
replacements, not bit-exact ports: OpenCV's bilateral uses quantized color
weights and pylops' inner LSQR differs from our fixed-point inner solve;
the eval harness treats these filters as part of the (pseudo-GT) baseline
method, where method-level equivalence is what matters (SURVEY.md §4).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "median_blur_3x3",
    "bilateral_filter",
    "tv_denoise_split_bregman",
]


def _shift2d(a: jax.Array, dy: int, dx: int, fill) -> jax.Array:
    """a shifted so out[y, x] = a[y+dy, x+dx]; vacated cells = fill."""
    H, W = a.shape
    out = a
    if dy:
        pad = jnp.full((abs(dy), W), fill, a.dtype)
        out = (
            jnp.concatenate([out[dy:], pad], 0)
            if dy > 0
            else jnp.concatenate([pad, out[:dy]], 0)
        )
    if dx:
        pad = jnp.full((H, abs(dx)), fill, a.dtype)
        out = (
            jnp.concatenate([out[:, dx:], pad], 1)
            if dx > 0
            else jnp.concatenate([pad, out[:, :dx]], 1)
        )
    return out


@jax.jit
def median_blur_3x3(img: jax.Array) -> jax.Array:
    """3x3 median with edge replication (cv2.medianBlur semantics).

    Median of 9 via a fixed sorting network (jnp.sort over a stacked axis is
    fine too, but the stack is tiny so sort is used for clarity).
    """
    img = jnp.asarray(img)
    H, W = img.shape
    # edge-replicated shifts: clamp instead of fill
    padded = jnp.pad(img, 1, mode="edge")
    stack = jnp.stack(
        [
            padded[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        ],
        axis=0,
    )
    return jnp.sort(stack, axis=0)[4]


@functools.partial(jax.jit, static_argnames=("d",))
def bilateral_filter(
    img: jax.Array, d: int = 5, sigma_color: float = 3.0, sigma_space: float = 3.0
) -> jax.Array:
    """Bilateral filter over a (d x d) window (cv2.bilateralFilter args).

    w(p, q) = exp(-|I(p)-I(q)|^2 / 2sc^2 - |p-q|^2 / 2ss^2), normalized.
    Border: replicate (OpenCV default).
    """
    img = jnp.asarray(img, jnp.float32)
    H, W = img.shape
    r = d // 2
    padded = jnp.pad(img, r, mode="edge")
    inv2sc = 1.0 / (2.0 * sigma_color * sigma_color)
    inv2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    num = jnp.zeros_like(img)
    den = jnp.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            q = padded[r + dy : r + dy + H, r + dx : r + dx + W]
            w = jnp.exp(
                -((q - img) ** 2) * inv2sc - (dy * dy + dx * dx) * inv2ss
            )
            num = num + w * q
            den = den + w
    return num / den


def _grad_x(u):  # backward difference, no edge wrap (edge row/col = 0)
    return u - _shift2d(u, 0, -1, 0.0)


def _grad_y(u):
    return u - _shift2d(u, -1, 0, 0.0)


def _div(px, py):  # negative adjoint of (grad_y, grad_x)
    return (_shift2d(px, 0, 1, 0.0) - px) + (_shift2d(py, 1, 0, 0.0) - py)


def _shrink(v, t):
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - t, 0.0)


@functools.partial(jax.jit, static_argnames=("niter", "niter_inner"))
def tv_denoise_split_bregman(
    y: jax.Array,
    mu: float = 0.5,
    eps: float = 0.1,
    niter: int = 20,
    niter_inner: int = 10,
) -> jax.Array:
    """Anisotropic TV-L2 denoise via split Bregman (Goldstein-Osher).

    Solves min_u mu/2 ||u - y||^2 + eps (|grad_x u|_1 + |grad_y u|_1) --
    the objective of the reference's pylops SplitBregman call
    (esl_utilities.py:206-223; same mu=0.5, eps=0.1, 20 outer / 10 inner
    iterations).  Splitting d = grad u with penalty lam/2 ||d - grad u -
    b||^2:

      u:  (mu I + lam grad^T grad) u = mu y - lam div(d - b)   [Jacobi sweeps]
      d:  shrink(grad u + b, eps / lam)
      b:  b += grad u - d

    The inner solve uses fixed-count Jacobi sweeps instead of pylops' LSQR
    (jit-friendly, no data-dependent iteration).
    """
    y = jnp.asarray(y, jnp.float32)
    lam = 2.0 * eps  # standard penalty choice; convergence-rate only
    thresh = eps / lam
    diag = mu + 4.0 * lam

    u = y
    dx = jnp.zeros_like(y)
    dy_ = jnp.zeros_like(y)
    bx = jnp.zeros_like(y)
    by = jnp.zeros_like(y)

    def outer(carry, _):
        u, dx, dy_, bx, by = carry
        rhs = mu * y - lam * _div(dx - bx, dy_ - by)

        def inner(u, _):
            neigh = (
                _shift2d(u, 0, 1, 0.0)
                + _shift2d(u, 0, -1, 0.0)
                + _shift2d(u, 1, 0, 0.0)
                + _shift2d(u, -1, 0, 0.0)
            )
            return (rhs + lam * neigh) / diag, None

        u, _ = jax.lax.scan(inner, u, None, length=niter_inner)
        gx = _grad_x(u)
        gy = _grad_y(u)
        dx = _shrink(gx + bx, thresh)
        dy_ = _shrink(gy + by, thresh)
        bx = bx + gx - dx
        by = by + gy - dy_
        return (u, dx, dy_, bx, by), None

    (u, *_), _ = jax.lax.scan(
        outer, (u, dx, dy_, bx, by), None, length=niter
    )
    return u
