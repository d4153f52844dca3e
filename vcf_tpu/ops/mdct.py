"""2D MDCT / modulated lapped transform (device-side).

Capability parity with src/2D-MDCT.py: Malvar MLT with a sine window
satisfying the Princen-Bradley condition (src/2D-MDCT.py:87-102), MDCT
and IMDCT as explicit cosine-matrix matmuls 2N->N / N->2N (:105-152),
1D analysis over a symmetric-extended signal (:155-207), overlap-add
synthesis (:210-244), separable 2D rows-then-columns (:247-305), and an
extended padding of +B per side whose offsets ride in the shape sidecar
(:446-476, :510-512).

Device design: all frames of a row are transformed at once as one matmul
with the (N, 2N) windowed cosine matrix — framing is a reshape of the
50%-overlap view built from two shifted slices; no Python loops.  With
the sqrt(2/N) scaling both ways, overlap-add reconstruction is exact
(TDAC), verified in tests/test_mdct_klt.py.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from vcf_tpu.codestream import CodeStream
from vcf_tpu.ops import color as color_ops
from vcf_tpu.ops import dct as dct_ops


@functools.lru_cache(maxsize=None)
def mdct_matrix(n: int) -> np.ndarray:
    """(N, 2N) windowed MDCT matrix: rows k, columns t, including the
    Princen-Bradley sine window."""
    t = np.arange(2 * n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)[:, None]
    window = np.sin(np.pi / (2 * n) * (t + 0.5))
    c = np.sqrt(2.0 / n) * np.cos(np.pi / n * (t[None, :] + 0.5 + n / 2) * (k + 0.5))
    return (c * window[None, :]).astype(np.float32)


def _frame_axis(x: jnp.ndarray, n: int, axis: int) -> jnp.ndarray:
    """Symmetric-extend by n, then 50%-overlap frames of length 2n.

    Input length L (multiple of n) -> (L//n + 1) frames; frame i covers
    ext[i*n : i*n + 2n].  Built from two shifted strided views (no
    gather).
    """
    l = x.shape[axis]
    xm = jnp.moveaxis(x, axis, 0)
    ext = jnp.concatenate(
        [xm[:n][::-1], xm, xm[-n:][::-1]], axis=0
    )  # (L + 2n, ...)
    f = l // n + 1
    # halves: ext[i*n:(i+1)*n] and ext[(i+1)*n:(i+2)*n]
    halves = ext.reshape((l + 2 * n) // n, n, *ext.shape[1:])
    first = halves[:-1]
    second = halves[1:]
    frames = jnp.concatenate([first, second], axis=1)  # (F, 2n, ...)
    return frames  # axis content moved to front


def mdct_axis(x: jnp.ndarray, n: int, axis: int) -> jnp.ndarray:
    """MDCT along `axis`: length L -> L + n coefficients (F*n, F=L/n+1)."""
    m = jnp.asarray(mdct_matrix(n))
    frames = _frame_axis(x, n, axis)  # (F, 2n, ...rest)
    coeff = jnp.einsum(
        "kt,ft...->fk...", m, frames, precision=jax.lax.Precision.HIGHEST
    )
    f = coeff.shape[0]
    out = coeff.reshape(f * n, *coeff.shape[2:])
    return jnp.moveaxis(out, 0, axis)


def imdct_axis(coeff: jnp.ndarray, n: int, axis: int, l_out: int) -> jnp.ndarray:
    """Inverse with overlap-add; returns length `l_out` (the original L)."""
    m = jnp.asarray(mdct_matrix(n))
    cm = jnp.moveaxis(coeff, axis, 0)
    f = cm.shape[0] // n
    frames = cm.reshape(f, n, *cm.shape[1:])
    y = jnp.einsum(
        "kt,fk...->ft...", m, frames, precision=jax.lax.Precision.HIGHEST
    )  # (F, 2n, ...)
    # overlap-add: ext[i*n + t] += y[i, t]; split each frame into two
    # halves and add shifted sums
    first = y[:, :n]   # lands at ext[i*n:(i+1)*n]
    second = y[:, n:]  # lands at ext[(i+1)*n:(i+2)*n]
    ext_len = (f + 1) * n
    rec = jnp.zeros((ext_len,) + y.shape[2:], y.dtype)
    rec = rec.at[: f * n].add(first.reshape(f * n, *y.shape[2:]))
    rec = rec.at[n:].add(second.reshape(f * n, *y.shape[2:]))
    out = rec[n : n + l_out]
    return jnp.moveaxis(out, 0, axis)


def analyze(img: jnp.ndarray, b: int) -> jnp.ndarray:
    """Separable 2D MDCT: (H, W, C) -> (H + b, W + b, C)."""
    y = mdct_axis(img, b, 0)
    return mdct_axis(y, b, 1)


def synthesize(coeff: jnp.ndarray, b: int, out_hw: Tuple[int, int]) -> jnp.ndarray:
    y = imdct_axis(coeff, b, 1, out_hw[1])
    return imdct_axis(y, b, 0, out_hw[0])


def mdct_scale_factor(b: int, quantizer: str) -> float:
    """The reference's empirical per-quantizer divisor that maps raw
    (unnormalized) MDCT coefficients into the range the quantizers
    expect from the DCT (src/2D-MDCT.py:406-421): LloydMax -> b/1.5;
    deadzone -> b/2 for b <= 8, b/4 for b >= 32, linear interpolation
    of the divisor in between."""
    if quantizer == "lloydmax":
        return b / 1.5
    if b <= 8:
        return b / 2.0
    if b >= 32:
        return b / 4.0
    t = (b - 8) / (32 - 8)
    return (8 / 2.0) + t * ((32 / 4.0) - (8 / 2.0))


def coeff_scale(b: int, quantizer: str) -> float:
    """Multiplier applied to OUR orthonormal 2D MDCT coefficients so the
    quantizer sees the reference's coefficient range.

    The reference transform is unnormalized (cos matrix only,
    src/2D-MDCT.py:105-127; the 2/N rides in the inverse :152), so its
    2D coefficients are (b/2)x ours (we carry sqrt(2/b) per axis); it
    then divides by `mdct_scale_factor` (:524, re-multiplied at :648).
    Net: quantizer input = ref_raw / s = (b/2)/s * ours."""
    return (b / 2.0) / mdct_scale_factor(b, quantizer)


class MDCT:
    def __init__(self, b: int):
        self.b = b
        self._analyze = jax.jit(functools.partial(analyze, b=b))

    def encode(self, codec, img: np.ndarray) -> CodeStream:
        cfg = codec.config
        b = self.b
        fwd, _ = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
        soff = codec.spatial_offset

        padded = dct_ops.pad_centered(jnp.asarray(img, jnp.float32), b)
        ct = fwd(padded - soff)
        coeff = self._analyze(ct)  # (H+b, W+b, C)
        # reference range normalization (2D-MDCT.py:524): quantizer sees
        # coefficients scaled to the DCT range
        coeff = coeff * coeff_scale(b, cfg.quantizer)
        if cfg.subbands:
            coeff = dct_ops.to_subbands(coeff, b)

        k, qside = codec._quantize(coeff)
        cs = CodeStream()
        codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
        cs.put_shape(img.shape)
        return cs

    def decode(self, codec, cs: CodeStream) -> np.ndarray:
        cfg = codec.config
        b = self.b
        _, inv = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
        soff = codec.spatial_offset

        shape = cs.get_shape()
        ph, pw = dct_ops.padded_shape(shape, b)[:2]
        k, qside = codec._load_indexes(cs, offset=soff, signed=True)
        coeff = codec._dequantize(k, qside, (ph + b, pw + b, 3))
        if cfg.subbands:
            coeff = dct_ops.from_subbands(coeff, b)
        # invert the encode-side range normalization (2D-MDCT.py:648
        # re-multiplies after synthesis; equivalent here by linearity)
        coeff = coeff / coeff_scale(b, cfg.quantizer)
        ct = synthesize(coeff, b, (ph, pw))
        y = inv(ct) + soff
        y = dct_ops.unpad_centered(y, shape)
        return np.asarray(jnp.clip(jnp.round(y), 0, 255)).astype(np.uint8)
