"""2D KLT (per-image PCA-learned block transform), device-side.

Capability parity with src/2D-KLT.py: per-channel PCA over the image's
own BxB blocks — covariance -> eigh -> eigenvectors sorted by
descending eigenvalue as transform rows (src/2D-KLT.py:147-167);
forward `X @ W.T`, inverse `Y @ W` (:248, :290); weights stored as
(3, D, D) float32 side info (:593-601); subband reordering reused from
the DCT stage (:603-610).

Device design: covariance is one (D, N) @ (N, D) matmul per channel; `jnp.linalg.eigh` runs on device.  Eigenvector sign is fixed
deterministically (largest-|.| component made positive) so encoders are
reproducible across runs.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vcf_tpu.codestream import CodeStream
from vcf_tpu.ops import color as color_ops
from vcf_tpu.ops import dct as dct_ops


def channel_blocks(img: jnp.ndarray, b: int) -> jnp.ndarray:
    """(H, W, C) -> (C, N, b*b) flattened blocks per channel."""
    h, w, c = img.shape
    x = img.reshape(h // b, b, w // b, b, c)
    x = x.transpose(4, 0, 2, 1, 3)  # (c, by, bx, b, b)
    return x.reshape(c, -1, b * b)


def channel_unblocks(blocks: jnp.ndarray, h: int, w: int, b: int) -> jnp.ndarray:
    c = blocks.shape[0]
    x = blocks.reshape(c, h // b, w // b, b, b)
    x = x.transpose(1, 3, 2, 4, 0)  # (by, b, bx, b, c)
    return x.reshape(h, w, c)


@jax.jit
def train_weights(blocks: jnp.ndarray) -> jnp.ndarray:
    """(C, N, D) -> (C, D, D) KLT weight matrices (rows = eigenvectors,
    descending eigenvalue, deterministic sign)."""
    mean = jnp.mean(blocks, axis=1, keepdims=True)
    centered = blocks - mean
    n = blocks.shape[1]
    cov = (
        jnp.einsum(
            "cnd,cne->cde", centered, centered,
            precision=jax.lax.Precision.HIGHEST,
        )
        / n
    )
    evals, evecs = jnp.linalg.eigh(cov)  # ascending
    evecs = evecs[:, :, ::-1]  # descending eigenvalue order
    w = jnp.swapaxes(evecs, 1, 2)  # rows = eigenvectors
    # deterministic sign: make the largest-magnitude entry of each row +
    idx = jnp.argmax(jnp.abs(w), axis=2, keepdims=True)
    sign = jnp.sign(jnp.take_along_axis(w, idx, axis=2))
    return w * jnp.where(sign == 0, 1.0, sign)


@jax.jit
def forward(blocks: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """(C, N, D), (C, D, D) -> coefficients (C, N, D): X @ W.T"""
    return jnp.einsum(
        "cnd,ced->cne", blocks, weights, precision=jax.lax.Precision.HIGHEST
    )


@jax.jit
def inverse(coeff: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Y @ W (weights orthonormal)."""
    return jnp.einsum(
        "cne,ced->cnd", coeff, weights, precision=jax.lax.Precision.HIGHEST
    )


# ---------------------------------------------------------------------------
# Pipeline flow (invoked from vcf_tpu.pipeline.Codec)
# ---------------------------------------------------------------------------

def encode(codec, img: np.ndarray) -> CodeStream:
    cfg = codec.config
    b = cfg.block_size
    fwd, _ = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
    soff = codec.spatial_offset

    padded = dct_ops.pad_centered(jnp.asarray(img, jnp.float32), b)
    ct = fwd(padded - soff)
    blocks = channel_blocks(ct, b)
    weights = train_weights(blocks)
    coeff = forward(blocks, weights)
    h, w = ct.shape[:2]
    coeff_img = channel_unblocks(coeff, h, w, b)
    if cfg.subbands:
        coeff_img = dct_ops.to_subbands(coeff_img, b)

    k, qside = codec._quantize(coeff_img)
    cs = CodeStream()
    codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
    cs.put_shape(img.shape)
    cs.put_array("weights", np.asarray(weights, dtype=np.float32))
    return cs


def decode(codec, cs: CodeStream) -> np.ndarray:
    cfg = codec.config
    b = cfg.block_size
    _, inv = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
    soff = codec.spatial_offset

    shape = cs.get_shape()
    padded_shape = dct_ops.padded_shape(shape, b)
    k, qside = codec._load_indexes(cs, offset=soff, signed=True)
    coeff_img = codec._dequantize(k, qside, padded_shape)
    if cfg.subbands:
        coeff_img = dct_ops.from_subbands(coeff_img, b)
    weights = jnp.asarray(cs.get_array("weights"))
    h, w = padded_shape[:2]
    coeff = channel_blocks(coeff_img, b)
    blocks = inverse(coeff, weights)
    ct = channel_unblocks(blocks, h, w, b)
    y = inv(ct) + soff
    y = dct_ops.unpad_centered(y, shape)
    return np.asarray(jnp.clip(jnp.round(y), 0, 255)).astype(np.uint8)
