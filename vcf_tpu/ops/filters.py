"""Decode-side denoising filters (device-side JAX).

Capability parity with the reference's L3 filter layer:
  * gaussian  — cv2.GaussianBlur(img, (s, s), 0)    (src/gaussian_blur.py:56)
  * nlm       — cv2.fastNlMeansDenoisingColored     (src/NLM.py:50-53)
  * bm3d      — bm3d_rgb(img/255, sigma/255)        (src/BM3D.py:42-54)

Device implementations: Gaussian blur is a separable depthwise
convolution; NLM is vectorized over the search window as a sum of
shifted-patch distances (one fused XLA program, no per-pixel loops);
BM3D is the real hard-threshold stage (r4): displacement-sweep block
matching, grouped 3D transform (2D block DCT x 1D DCT across the
group), 2.7-sigma hard threshold, and weighted re-aggregation of every
group member at its source — entirely gather- and sort-free (both are
pathological on this backend).  +1.6-2.1 dB over the r1-r3 two-stage
approximation (`bm3d_approx`, kept for reference) on noisy synthetic
images; the reference's binary `bm3d` package is not reproducible
bit-for-bit (SURVEY §2.3 allows "JAX BM3D").
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from vcf_tpu.ops import dct as dct_ops


def gaussian_kernel_1d(size: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics: sigma<=0 -> 0.3*((size-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("size",))
def gaussian_blur(img: jnp.ndarray, size: int) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 borders (cv2 default)."""
    k = jnp.asarray(gaussian_kernel_1d(size))
    x = img.astype(jnp.float32)
    pad = size // 2
    # rows
    xp = jnp.pad(x, ((pad, pad), (0, 0), (0, 0)), mode="reflect")
    idx = jnp.arange(x.shape[0])[:, None] + jnp.arange(size)[None, :]
    x = jnp.einsum("s,hswc->hwc", k, xp[idx],
                   precision=jax.lax.Precision.HIGHEST)
    # cols
    xp = jnp.pad(x, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    idx = jnp.arange(x.shape[1])[:, None] + jnp.arange(size)[None, :]
    x = jnp.einsum("s,hwsc->hwc", k, xp[:, idx],
                   precision=jax.lax.Precision.HIGHEST)
    return x


@functools.partial(jax.jit, static_argnames=("template", "search"))
def nlm(img: jnp.ndarray, h: float, template: int = 7, search: int = 21) -> jnp.ndarray:
    """Non-local means, vectorized over the search window.

    For every offset d in the search window, the patch distance field is
    a box filter of the squared pixel difference between the image and
    its shifted copy; weights are exp(-dist / h^2).  This evaluates all
    offsets as one big elementwise program — HBM-bandwidth bound, no
    gathers.
    """
    x = img.astype(jnp.float32)
    hh, ww, c = x.shape
    t_rad = template // 2
    s_rad = search // 2
    pad = s_rad + t_rad
    xp = jnp.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")

    box = jnp.ones((template, template, 1, 1), jnp.float32) / (template * template)

    def box_filter(v):
        # v: (H+2t, W+2t, C) -> valid box mean (H, W, C)
        return jax.lax.conv_general_dilated(
            v[None], box, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=1,
            precision=jax.lax.Precision.HIGHEST,
        )[0]

    offsets = [
        (dy, dx)
        for dy in range(-s_rad, s_rad + 1)
        for dx in range(-s_rad, s_rad + 1)
    ]

    center = xp[pad : pad + hh, pad : pad + ww]
    num = jnp.zeros_like(x)
    den = jnp.zeros((hh, ww, 1), jnp.float32)
    h2 = h * h
    for dy, dx in offsets:
        shifted_ext = xp[
            pad + dy - t_rad : pad + dy + hh + t_rad,
            pad + dx - t_rad : pad + dx + ww + t_rad,
        ]
        center_ext = xp[pad - t_rad : pad + hh + t_rad, pad - t_rad : pad + ww + t_rad]
        d2 = box_filter(jnp.mean((shifted_ext - center_ext) ** 2, axis=-1, keepdims=True))
        wgt = jnp.exp(-d2 / h2)
        num = num + wgt * xp[pad + dy : pad + dy + hh, pad + dx : pad + dx + ww]
        den = den + wgt
    return num / den


def bm3d_approx(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Two-stage BM3D-flavored shrinkage (documented approximation):
    stage 1 = blockwise DCT hard-thresholding at 2.7*sigma;
    stage 2 = NLM pass guided by the stage-1 estimate."""
    x = img.astype(jnp.float32)
    b = 8
    padded = dct_ops.pad_centered(x, b)
    coeff = dct_ops.analyze(padded, b)
    thresh = 2.7 * sigma
    # keep DC intact per block
    h, w, c = coeff.shape
    blocks = coeff.reshape(h // b, b, w // b, b, c)
    mask = jnp.abs(blocks) >= thresh
    mask = mask.at[:, 0, :, 0, :].set(True)
    blocks = jnp.where(mask, blocks, 0.0)
    est = dct_ops.synthesize(blocks.reshape(h, w, c), b)
    est = dct_ops.unpad_centered(est, x.shape)
    out = nlm(est, h=max(sigma * 0.6, 1.0), template=7, search=11)
    return out


def _bm3d_stage(noisy, guide, sigma, b, n_group, s, step_phases,
                wiener: bool):
    """One BM3D stage.  Matching and (for the Wiener stage) the
    shrinkage spectrum come from `guide`; the filtered data is `noisy`.
    Returns the stage estimate (same shape as noisy)."""
    h0, w0, _ = noisy.shape
    pady, padx = (-h0) % b, (-w0) % b
    xpad = jnp.pad(noisy, ((0, pady), (0, padx), (0, 0)), mode="reflect")
    gpad = jnp.pad(guide, ((0, pady), (0, padx), (0, 0)), mode="reflect")
    h, w, _ = xpad.shape
    nby, nbx = h // b, w // b
    lw = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)

    disps = [(dy, dx) for dy in range(-s, s + 1) for dx in range(-s, s + 1)]
    disps.sort(key=lambda d: (d != (0, 0), d))      # self first
    disp_arr = jnp.asarray(np.asarray(disps, np.int32))
    n_disp = len(disps)
    thresh = 2.7 * sigma
    sig2 = sigma * sigma
    d1 = jnp.asarray(dct_ops.dct_matrix(n_group))

    def px(mask_blocks):
        return jnp.repeat(jnp.repeat(mask_blocks, b, 0), b, 1)[..., None]

    out_acc = jnp.zeros_like(xpad)
    wt_acc = jnp.zeros((h, w, 1), jnp.float32)
    offs = [(i * b // step_phases, j * b // step_phases)
            for i in range(step_phases) for j in range(step_phases)]

    for (oy, ox) in offs:
        xs = jnp.roll(xpad, (-oy, -ox), (0, 1))
        gs = jnp.roll(gpad, (-oy, -ox), (0, 1))
        luma = jnp.einsum("hwc,c->hw", gs, lw,
                          precision=jax.lax.Precision.HIGHEST)

        def dist_body(_, d):
            shifted = jnp.roll(luma, (-d[0], -d[1]), (0, 1))
            dblk = ((luma - shifted) ** 2).reshape(nby, b, nbx, b).sum((1, 3))
            return 0, dblk

        _, dvol = jax.lax.scan(dist_body, 0, disp_arr)

        sel_idx = []
        dwork = dvol.at[0].set(-1.0)
        for _ in range(n_group):
            idx = jnp.argmin(dwork, axis=0)
            sel_idx.append(idx)
            dwork = jnp.where(
                jnp.arange(n_disp)[:, None, None] == idx[None], jnp.inf,
                dwork)
        sel = jnp.stack(sel_idx)                     # (N, nby, nbx)

        def build_body(acc, di_d):
            accx, accg = acc
            di, d = di_d
            m = px((sel == di).astype(jnp.float32).reshape(
                n_group * nby, nbx)).reshape(n_group, h, w, 1)
            sx = jnp.roll(xs, (-d[0], -d[1]), (0, 1))
            accx = accx + m * sx[None]
            if wiener:
                sg_ = jnp.roll(gs, (-d[0], -d[1]), (0, 1))
                accg = accg + m * sg_[None]
            return (accx, accg), None

        acc0 = jnp.zeros((n_group, h, w, 3), jnp.float32)
        (grp, grp_g), _ = jax.lax.scan(
            build_body, (acc0, acc0), (jnp.arange(n_disp), disp_arr))

        coeff2 = jax.vmap(lambda g: dct_ops.analyze(g, b))(grp)
        coeff3 = jnp.einsum("mn,nhwc->mhwc", d1, coeff2,
                            precision=jax.lax.Precision.HIGHEST)
        if wiener:
            cg2 = jax.vmap(lambda g: dct_ops.analyze(g, b))(grp_g)
            cg3 = jnp.einsum("mn,nhwc->mhwc", d1, cg2,
                             precision=jax.lax.Precision.HIGHEST)
            wsh = cg3 * cg3 / (cg3 * cg3 + sig2)     # Wiener spectrum
            coeff3 = coeff3 * wsh
            # aggregation weight ~ 1 / sum(W^2) per group (standard)
            wsum = wsh.reshape(n_group, nby, b, nbx, b, 3).sum(
                (0, 2, 4, 5)) ** 2
            wgt = 1.0 / (1e-2 + wsum / (n_group * b * b * 3))
        else:
            keep = jnp.abs(coeff3) >= thresh
            # always keep each block's spatial DC in the group-DC layer
            dcpos = np.zeros((b, b), bool)
            dcpos[0, 0] = True
            dc_hw = jnp.asarray(np.tile(dcpos, (nby, nbx)))[..., None]
            keep = keep.at[0].set(keep[0] | dc_hw)
            coeff3 = jnp.where(keep, coeff3, 0.0)
            nret = keep.reshape(n_group, nby, b, nbx, b, 3).sum(
                (0, 2, 4, 5)).astype(jnp.float32)
            wgt = 1.0 / (1.0 + nret)

        # inverse 1D transform: out_n = sum_m d1[m, n] * c_m = d1^T c
        inv2 = jnp.einsum("mn,mhwc->nhwc", d1, coeff3,
                          precision=jax.lax.Precision.HIGHEST)
        est = jax.vmap(lambda g: dct_ops.synthesize(g, b))(inv2)

        wpx = px(wgt)

        def scatter_body(carry, di_d):
            oacc, wacc = carry
            di, d = di_d
            m = px((sel == di).astype(jnp.float32).reshape(
                n_group * nby, nbx)).reshape(n_group, h, w, 1)
            contrib = jnp.sum(est * m, axis=0) * wpx
            wsum_ = jnp.sum(m, axis=0) * wpx
            oacc = oacc + jnp.roll(contrib, (d[0] + oy, d[1] + ox), (0, 1))
            wacc = wacc + jnp.roll(wsum_, (d[0] + oy, d[1] + ox), (0, 1))
            return (oacc, wacc), None

        (out_acc, wt_acc), _ = jax.lax.scan(
            scatter_body, (out_acc, wt_acc),
            (jnp.arange(n_disp), disp_arr))

    out = out_acc / jnp.maximum(wt_acc, 1e-6)
    return out[:h0, :w0]


@functools.partial(
    jax.jit, static_argnames=("b", "n_group", "s", "step_phases",
                              "stages"))
def bm3d(img: jnp.ndarray, sigma: float, b: int = 8, n_group: int = 8,
         s: int = 8, step_phases: int = 2, stages: int = 2) -> jnp.ndarray:
    """Real two-stage BM3D, gather- and sort-free formulation
    (reference: the `bm3d` package's bm3d_rgb, src/BM3D.py:42-54).

    Stage 1 (hard threshold): for each reference patch, the N most
    similar patches in a (2s+1)^2 window are stacked, 3D-transformed
    (2D block DCT x 1D DCT across the group), hard-thresholded at
    2.7*sigma, inverted, and every member aggregates back at its source
    weighted 1/(1+retained).  Stage 2 (Wiener): matching and the
    shrinkage spectrum come from the stage-1 estimate,
    W = C1^2/(C1^2 + sigma^2) applied to the noisy groups.

    Device mapping (no gathers, no sorts): block matching is the MC/SAD
    displacement-sweep trick (lax.scan of rolls + box sums); top-N is
    N argmin+mask passes; the group gather AND the aggregation scatter
    are the same sweep with per-block selection masks; `step_phases`^2
    shifted grids approximate the reference's overlapping stride.
    """
    x = img.astype(jnp.float32)
    est = _bm3d_stage(x, x, sigma, b, n_group, s, step_phases,
                      wiener=False)
    if stages < 2:
        return est
    return _bm3d_stage(x, est, sigma, b, n_group, s, step_phases,
                       wiener=True)


def get(config):
    """Return a host-callable filter fn(uint8 image) -> uint8 image."""
    name = config.filter

    if name == "gaussian":
        size = config.filter_size

        def run(img):
            out = gaussian_blur(jnp.asarray(img), size)
            return np.asarray(jnp.clip(jnp.round(out), 0, 255)).astype(np.uint8)

        return run
    if name == "nlm":
        h, t, s = config.nlm_h, config.nlm_template, config.nlm_search

        def run(img):
            out = nlm(jnp.asarray(img), h, t, s)
            return np.asarray(jnp.clip(jnp.round(out), 0, 255)).astype(np.uint8)

        return run
    if name == "bm3d":
        sigma = config.bm3d_sigma

        def run(img):
            out = bm3d(jnp.asarray(img), sigma)
            return np.asarray(jnp.clip(jnp.round(out), 0, 255)).astype(np.uint8)

        return run
    raise ValueError(f"unknown filter {name!r}")
