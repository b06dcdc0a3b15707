"""Image pyramid + Gaussian blur.

Replaces reference ORBextractor::ComputePyramid (src/ORBextractor.cc:497-515,
8 levels, scale 1.2, bilinear resize from the previous level) and the 7x7
sigma=2 GaussianBlur applied before descriptor computation
(src/ORBextractor.cc:472-494).

Design: every level has a static shape derived from the config at trace
time; resize is a pair of small dense matmuls; blur is a separable depthwise
convolution (two 1-D passes of shifted adds). All ops carry a leading batch
axis.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static per-level (H, W) list; level l = round(dim / scale^l)."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Bilinear resampling as a constant [n_out, n_in] matrix (half-pixel
    centers, clamped edges — the same mapping as jax.image.resize
    method='linear' antialias=False and cv::resize INTER_LINEAR). Two
    nonzeros per row; applied as a dense matmul, which is cheap at
    pyramid sizes and avoids a gather-based resize."""
    x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    x = np.clip(x, 0.0, n_in - 1)
    x0 = np.floor(x).astype(np.int64)
    x1 = np.minimum(x0 + 1, n_in - 1)
    f = (x - x0).astype(np.float32)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), x0] += 1.0 - f
    M[np.arange(n_out), x1] += f
    return M


def resize_bilinear_matmul(img: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Separable bilinear resize of f32[B, H, W] to [B, h, w] as two
    matmuls: out = Ry @ img @ Rx^T.

    HIGHEST precision: at reduced precision (TF32/bf16 inputs) each level
    picks up ~0.5-greylevel error that CASCADES down the pyramid (levels
    resize from the previous level), visibly perturbing FAST scores vs the
    CPU backend; full-f32 costs ~nothing at pyramid sizes."""
    import jax
    Ry = jnp.asarray(_resize_matrix(h, img.shape[1]))
    Rx = jnp.asarray(_resize_matrix(w, img.shape[2]))
    t = jnp.einsum("oh,bhw->bow", Ry, img,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("bow,pw->bop", t, Rx,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float):
    """img: f32[B, H, W] -> list of f32[B, Hl, Wl], resized successively from
    the previous level (matching the reference's cascaded cv::resize)."""
    B, H, W = img.shape
    shapes = level_shapes(H, W, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        h, w = shapes[l]
        levels.append(resize_bilinear_matmul(levels[-1], h, w))
    return levels


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """OpenCV getGaussianKernel semantics: exp(-x^2/(2 sigma^2)), normalized."""
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("ksize",))
def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with reflect-101 border (OpenCV default).
    img: f32[B, H, W]."""
    k = jnp.asarray(gaussian_kernel_1d(ksize, sigma))
    pad = ksize // 2
    x = jnp.pad(img, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    # Convolve along H: treat W as batch via dot with unrolled slices.
    x = _conv1d_axis(x, k, axis=1)
    x = jnp.pad(x, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
    x = _conv1d_axis(x, k, axis=2)
    return x


def _conv1d_axis(x: jnp.ndarray, k: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Valid-mode 1-D convolution along `axis` as a sum of shifted slices —
    compiles to fused adds, avoiding conv layout shuffles for tiny taps."""
    n = k.shape[0]
    L = x.shape[axis] - n + 1
    out = None
    for i in range(n):
        sl = jax.lax.slice_in_dim(x, i, i + L, axis=axis)
        out = sl * k[i] if out is None else out + sl * k[i]
    return out
