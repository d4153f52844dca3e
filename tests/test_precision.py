"""Float matmuls in the codec are pinned to Precision.HIGHEST: on a GPU
an unpinned float32 dot may run in TF32 (about three decimal digits),
which moves quantization indexes.  Each pinned op is held to a float64
NumPy reference."""

import numpy as np
import jax.numpy as jnp

from vcf_tpu.io import test_image as make_image

IMG = make_image(48, 64, seed=4)


def test_to_luma():
    from vcf_tpu.ops import motion

    ref = IMG.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    np.testing.assert_allclose(np.asarray(motion.to_luma(jnp.asarray(IMG))),
                               ref, rtol=0, atol=1e-4)


def test_gaussian_blur():
    from vcf_tpu.ops import filters

    k = filters.gaussian_kernel_1d(5).astype(np.float64)
    x = IMG.astype(np.float64)
    pad = np.pad(x, ((2, 2), (0, 0), (0, 0)), mode="reflect")
    rows = sum(k[i] * pad[i:i + x.shape[0]] for i in range(5))
    pad = np.pad(rows, ((0, 0), (2, 2), (0, 0)), mode="reflect")
    ref = sum(k[i] * pad[:, i:i + x.shape[1]] for i in range(5))
    got = np.asarray(filters.gaussian_blur(jnp.asarray(IMG), 5))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_dct_analyze():
    from vcf_tpu.ops import dct

    x = IMG.astype(np.float64) - 128
    d = dct.dct_matrix(8).astype(np.float64)
    blocks = x.reshape(6, 8, 8, 8, 3)
    ref = np.einsum("ur,arbsc,vs->aubvc", d, blocks, d).reshape(x.shape)
    got = np.asarray(dct.analyze(jnp.asarray(x, jnp.float32), 8))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_color_forward():
    from vcf_tpu.ops import color

    ref = IMG.astype(np.float64) @ np.asarray(color.YCOCG_FWD, np.float64).T
    got = np.asarray(color.ycocg_forward(jnp.asarray(IMG, jnp.float32)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_lloydmax_centroids():
    """One Lloyd step's level update (the mass and moment einsums) is
    the float64 histogram-weighted centroid of each cell."""
    from vcf_tpu.ops import quantize

    q_min, q_max, qss = -512, 511, 64
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 5000, (3, q_max - q_min + 1))
    levels = np.asarray(quantize.lloydmax_train_from_hist(
        jnp.asarray(hist), qss, q_min, q_max, iters=1))
    n = quantize.lloydmax_levels(qss, q_min, q_max)
    init = q_min + (np.arange(n) + 0.5) * ((q_max - q_min + 1) / n)
    support = np.arange(q_min, q_max + 1, dtype=np.float64)
    cell = np.searchsorted(0.5 * (init[1:] + init[:-1]), support,
                           side="right")
    w = hist.astype(np.float64) + 1.0
    for j in range(n):
        sel = cell == j
        ref = (w[:, sel] * support[sel]).sum(1) / w[:, sel].sum(1)
        np.testing.assert_allclose(levels[:, j], ref, rtol=1e-6, atol=1e-3)
