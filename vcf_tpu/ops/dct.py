"""Block 2D DCT and subband reordering (device-side).

Capabilities of the reference's `DCT2D.block_DCT` package
(`analyze_image`, `synthesize_image`, `get_subbands`, `get_blocks`;
used at src/2D-DCT.py:17-20): per-channel block-wise orthonormal 2D
DCT-II, and a permutation that gathers coefficient (u, v) of every
block into subband (u, v).

Device design: the separable 2D DCT of all blocks at once is two
batched matmuls with the BxB orthonormal DCT matrix — this keeps the
matmul work with static shapes.  The subband permutation is a pure
reshape/transpose, which XLA fuses into the surrounding copy.

Layout conventions (channel-last images `(H, W, C)`, H and W already
multiples of the block size B):

    blocks view      : (H//B, B, W//B, B, C)
    subband layout   : out[u*(H//B)+by, v*(W//B)+bx, c]
                         = coeff[by*B+u, bx*B+v, c]
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D: y = D @ x transforms one length-n signal."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] /= np.sqrt(2.0)
    return m.astype(np.float32)


def _to_blocks(img: jnp.ndarray, b: int) -> jnp.ndarray:
    h, w, c = img.shape
    return img.reshape(h // b, b, w // b, b, c)


def _from_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    nby, b, nbx, b2, c = blocks.shape
    return blocks.reshape(nby * b, nbx * b2, c)


def analyze(img: jnp.ndarray, b: int) -> jnp.ndarray:
    """Blockwise forward 2D DCT-II of a (H, W, C) image; H, W % b == 0.

    Equivalent of DCT2D.block_DCT.analyze_image (src/2D-DCT.py:303).
    """
    d = jnp.asarray(dct_matrix(b))
    x = _to_blocks(img.astype(jnp.float32), b)
    # rows: contract the first intra-block axis; cols: the second.
    y = jnp.einsum("ur,yrxsc->yuxsc", d, x, precision=jax.lax.Precision.HIGHEST)
    y = jnp.einsum("vs,yuxsc->yuxvc", d, y, precision=jax.lax.Precision.HIGHEST)
    return _from_blocks(y)


def synthesize(coeff: jnp.ndarray, b: int) -> jnp.ndarray:
    """Blockwise inverse 2D DCT (transpose of `analyze`)."""
    d = jnp.asarray(dct_matrix(b))
    y = _to_blocks(coeff.astype(jnp.float32), b)
    x = jnp.einsum("ur,yuxvc->yrxvc", d, y, precision=jax.lax.Precision.HIGHEST)
    x = jnp.einsum("vs,yrxvc->yrxsc", d, x, precision=jax.lax.Precision.HIGHEST)
    return _from_blocks(x)


def to_subbands(coeff: jnp.ndarray, b: int) -> jnp.ndarray:
    """Gather coefficient (u, v) of all blocks into subband (u, v)
    (equivalent of DCT2D.block_DCT.get_subbands, src/2D-DCT.py:333-336)."""
    h, w, c = coeff.shape
    x = coeff.reshape(h // b, b, w // b, b, c)          # (by, u, bx, v, c)
    x = x.transpose(1, 0, 3, 2, 4)                       # (u, by, v, bx, c)
    return x.reshape(h, w, c)


def from_subbands(sub: jnp.ndarray, b: int) -> jnp.ndarray:
    """Inverse of `to_subbands` (equivalent of get_blocks)."""
    h, w, c = sub.shape
    x = sub.reshape(b, h // b, b, w // b, c)             # (u, by, v, bx, c)
    x = x.transpose(1, 0, 3, 2, 4)                       # (by, u, bx, v, c)
    return x.reshape(h, w, c)


# ---------------------------------------------------------------------------
# Padding (reference: src/2D-DCT.py:187-229 pad_and_center_to_multiple_of_
# block_size / remove_padding — centered zero pad, extra to bottom/right).
# ---------------------------------------------------------------------------

def padded_shape(shape, b: int):
    h, w = shape[0], shape[1]
    return (-(-h // b) * b, -(-w // b) * b) + tuple(shape[2:])


def pad_centered(img: jnp.ndarray, b: int) -> jnp.ndarray:
    h, w = img.shape[0], img.shape[1]
    th, tw = -(-h // b) * b, -(-w // b) * b
    ph, pw = th - h, tw - w
    pads = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
    pads += [(0, 0)] * (img.ndim - 2)
    return jnp.pad(img, pads)


def unpad_centered(img: jnp.ndarray, original_shape) -> jnp.ndarray:
    h, w = original_shape[0], original_shape[1]
    ph, pw = img.shape[0] - h, img.shape[1] - w
    top, left = ph // 2, pw // 2
    return img[top : top + h, left : left + w]


# ---------------------------------------------------------------------------
# Perceptual (JPEG-table) coefficient pre-scaling (reference:
# src/2D-DCT.py:63-90 tables, :313-327 apply).  Coefficients are *scaled*
# before quantization by table/max(table) per channel class and unscaled on
# decode.  Tables are resized to BxB with area/linear interpolation.
# ---------------------------------------------------------------------------

JPEG_LUMA_QT = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
JPEG_CHROMA_QT = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _linear_coeffs(dst_n: int, src_n: int):
    """Half-pixel-center bilinear taps with 11-bit fixed-point weights
    (the standard imaging fixed-point convention; border clamp)."""
    scale = src_n / dst_n
    idx = np.empty(dst_n, np.int64)
    a0 = np.empty(dst_n, np.int64)
    for x in range(dst_n):
        fx = (x + 0.5) * scale - 0.5
        s = int(np.floor(fx))
        f = fx - s
        if s < 0:
            s, f = 0, 0.0
        if s >= src_n - 1:
            s, f = src_n - 2, 1.0
        idx[x] = s
        a0[x] = int(np.rint((1.0 - f) * 2048.0))
    return idx, a0


def resize_linear_u8(src: np.ndarray, b: int) -> np.ndarray:
    """uint8 bilinear resize to (b, b), 22-bit fixed-point accumulate.

    Matches cv2.resize(..., INTER_LINEAR) to within ±1 on half-integer
    cases (cv2 dispatches to IPP whose internal rounding is not
    specified); pinned against stored cv2 vectors in
    tests/test_dct.py."""
    sh, sw = src.shape
    xs, ax = _linear_coeffs(b, sw)
    ys, ay = _linear_coeffs(b, sh)
    s = src.astype(np.int64)
    h = s[:, xs] * ax[None, :] + s[:, xs + 1] * (2048 - ax[None, :])
    out = (h[ys, :] * ay[:, None] + h[ys + 1, :] * (2048 - ay[:, None])
           + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(dst_n: int, src_n: int):
    """1-D area-decimation table [(dst, src, w)] with float32 weights
    (partial-cell coverage / scale), the cv2 generic-area layout."""
    scale = src_n / dst_n
    cell = np.float32(1.0 / scale)
    tab = []
    for dx in range(dst_n):
        f1 = dx * scale
        f2 = f1 + scale
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        if s1 - f1 > 1e-3:
            tab.append((dx, s1 - 1, np.float32((s1 - f1) / scale)))
        for sx in range(s1, s2):
            tab.append((dx, sx, cell))
        if f2 - s2 > 1e-3:
            tab.append((dx, s2, np.float32((f2 - s2) / scale)))
    return tab


def resize_area_u8(src: np.ndarray, b: int) -> np.ndarray:
    """uint8 area-average downscale to (b, b), bit-exact to
    cv2.resize(..., INTER_AREA) for the 8x8 JPEG tables (integer-ratio
    fast path: (sum + area/2) // area; generic path: float32 separable
    weights, round-half-even) — pinned in tests/test_dct.py."""
    sh, sw = src.shape
    ry, rx = sh / b, sw / b
    if ry == int(ry) and rx == int(rx):
        iy, ix = int(ry), int(rx)
        area = iy * ix
        s = src.astype(np.int64).reshape(b, iy, b, ix).sum((1, 3))
        return ((s + area // 2) // area).astype(np.uint8)
    hbuf = np.zeros((sh, b), np.float32)
    for dx, sx, w in _area_tab(b, sw):
        hbuf[:, dx] += src[:, sx].astype(np.float32) * w
    out = np.zeros((b, b), np.float32)
    for dy, sy, w in _area_tab(b, sh):
        out[dy, :] += hbuf[sy, :] * w
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def perceptual_tables(b: int):
    """(luma, chroma) BxB scale tables in [~0.08, 1].  The reference
    resizes the uint8 JPEG tables with cv2 (INTER_AREA if b<8 else
    INTER_LINEAR, src/2D-DCT.py:63-90) and divides by the max entry
    (121 luma / 99 chroma); the resize is reproduced by the pure-numpy
    resamplers above — no cv2 dependency anywhere in ops/."""
    if b < 8:
        luma = resize_area_u8(JPEG_LUMA_QT.astype(np.uint8), b)
        chroma = resize_area_u8(JPEG_CHROMA_QT.astype(np.uint8), b)
    else:
        luma = resize_linear_u8(JPEG_LUMA_QT.astype(np.uint8), b)
        chroma = resize_linear_u8(JPEG_CHROMA_QT.astype(np.uint8), b)
    return luma.astype(np.float32) / 121.0, chroma.astype(np.float32) / 99.0


def perceptual_scale(coeff: jnp.ndarray, b: int, inverse: bool = False) -> jnp.ndarray:
    """Multiply (or divide) block-layout coefficients by the per-frequency
    perceptual tables; channel 0 uses the luma table, channels 1-2 chroma."""
    luma, chroma = perceptual_tables(b)
    table = jnp.stack(
        [jnp.asarray(luma), jnp.asarray(chroma), jnp.asarray(chroma)], axis=-1
    )  # (b, b, 3)
    h, w, c = coeff.shape
    x = coeff.reshape(h // b, b, w // b, b, c)
    t = table[None, :, None, :, :]
    x = x / t if inverse else x * t
    return x.reshape(h, w, c)
