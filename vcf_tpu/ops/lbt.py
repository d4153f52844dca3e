"""Learned block transform (LBT) — optax-trained linear autoencoder.

Capability parity with src/2D-LBT.py: a per-image learned linear
encoder/decoder pair over flattened BxB blocks (no bias), trained with
Adam on loss = MSE + lambda * mean(log var(coefficients)) — the
coding-gain regularizer (src/2D-LBT.py:105-128).  The decoder weights
and the block mean are codestream side information
(src/2D-LBT.py:130-136 stores them as .pth; we store float32 arrays).

Device design: training is a jitted optax loop over all blocks of the
image at once (two matmuls per step); weights are
initialized from the DCT basis, which both speeds convergence and
makes the seedless path deterministic.  The pipeline flow reuses the
DCT skeleton (same padding, quantizer hooks, uint8 casting).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
import optax

from vcf_tpu.codestream import CodeStream, PAYLOAD
from vcf_tpu.ops import color as color_ops
from vcf_tpu.ops import dct as dct_ops


def blocks_of(img: jnp.ndarray, b: int) -> jnp.ndarray:
    """(H, W, C) -> (N*C, b*b): per-channel flattened blocks."""
    h, w, c = img.shape
    x = img.reshape(h // b, b, w // b, b, c)
    x = x.transpose(0, 2, 4, 1, 3)  # (by, bx, c, b, b)
    return x.reshape(-1, b * b)


def unblocks_of(blocks: jnp.ndarray, h: int, w: int, c: int, b: int) -> jnp.ndarray:
    x = blocks.reshape(h // b, w // b, c, b, b)
    x = x.transpose(0, 3, 1, 4, 2)
    return x.reshape(h, w, c)


def dct_init(b: int) -> np.ndarray:
    """Separable 2D DCT basis as a (b*b, b*b) matrix (kron of 1D bases)."""
    d = dct_ops.dct_matrix(b)
    return np.kron(d, d).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("epochs", "lr", "coding_lambda"))
def train(
    blocks: jnp.ndarray, enc0: jnp.ndarray, dec0: jnp.ndarray,
    epochs: int = 200, lr: float = 1e-3, coding_lambda: float = 0.0,
):
    """Full-batch Adam training of (encoder, decoder) weight matrices.

    blocks: (N, D) mean-removed training blocks.
    Returns (encoder, decoder) after `epochs` steps.
    """
    params = {"enc": enc0, "dec": dec0}
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def loss_fn(p):
        coeff = jnp.dot(blocks, p["enc"].T, precision=jax.lax.Precision.HIGHEST)
        recon = jnp.dot(coeff, p["dec"].T, precision=jax.lax.Precision.HIGHEST)
        mse = jnp.mean((recon - blocks) ** 2)
        reg = 0.0
        if coding_lambda:
            var = jnp.var(coeff, axis=0) + 1e-8
            reg = coding_lambda * jnp.mean(jnp.log(var))
        return mse + reg

    def step(carry, _):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    (params, _), losses = jax.lax.scan(step, (params, opt_state), None, length=epochs)
    return params["enc"], params["dec"], losses


def train_step_fn(lr: float = 1e-3, coding_lambda: float = 1e-2):
    """One SPMD-ready training step (used by __graft_entry__'s multichip
    dry run): grads over the local shard of blocks, psum'd over the mesh.

    Returns step(params, opt_state, blocks, axis_names) -> (params, opt_state, loss).
    """
    opt = optax.adam(lr)

    def loss_fn(p, blocks):
        coeff = jnp.dot(blocks, p["enc"].T, precision=jax.lax.Precision.HIGHEST)
        recon = jnp.dot(coeff, p["dec"].T, precision=jax.lax.Precision.HIGHEST)
        mse = jnp.mean((recon - blocks) ** 2)
        var = jnp.var(coeff, axis=0) + 1e-8
        return mse + coding_lambda * jnp.mean(jnp.log(var))

    def step(params, opt_state, blocks, axis_names=()):
        loss, grads = jax.value_and_grad(loss_fn)(params, blocks)
        for ax in axis_names:
            grads = jax.lax.pmean(grads, ax)
            loss = jax.lax.pmean(loss, ax)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return opt, step


# ---------------------------------------------------------------------------
# Pipeline flow hooks (invoked from vcf_tpu.pipeline.Codec)
# ---------------------------------------------------------------------------

def encode(codec, img: np.ndarray) -> CodeStream:
    cfg = codec.config
    b = cfg.block_size
    fwd, _ = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
    soff = codec.spatial_offset

    padded = dct_ops.pad_centered(jnp.asarray(img, jnp.float32), b)
    ct = fwd(padded - soff)
    blocks = blocks_of(ct, b)
    mean = jnp.mean(blocks, axis=0)
    centered = blocks - mean

    w0 = jnp.asarray(dct_init(b))
    enc_w, dec_w, _ = train(
        centered, w0, w0.T,
        epochs=cfg.lbt_epochs, lr=cfg.lbt_lr, coding_lambda=cfg.lbt_lambda,
    )
    coeff = jnp.dot(centered, enc_w.T, precision=jax.lax.Precision.HIGHEST)
    h, w, c = ct.shape
    coeff_img = unblocks_of(coeff, h, w, c, b)
    if cfg.subbands:
        coeff_img = dct_ops.to_subbands(coeff_img, b)

    k, qside = codec._quantize(coeff_img)
    cs = CodeStream()
    codec._store_indexes(cs, k, qside, offset=soff, dtype=np.uint8)
    cs.put_shape(img.shape)
    # decoder weights + mean are side info (src/2D-LBT.py:130-136);
    # --side_info redirects them to an external file (2D-LBT.py:391-398)
    if cfg.lbt_side_info:
        np.savez(cfg.lbt_side_info,
                 weights=np.asarray(dec_w, dtype=np.float32),
                 mean=np.asarray(mean, dtype=np.float32))
    else:
        cs.put_array("weights", np.asarray(dec_w, dtype=np.float32))
        cs.put_array("mean", np.asarray(mean, dtype=np.float32))
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
    if cfg.lbt_side_info:
        with np.load(cfg.lbt_side_info if cfg.lbt_side_info.endswith(".npz")
                     else cfg.lbt_side_info + ".npz") as z:
            dec_w = jnp.asarray(z["weights"])
            mean = jnp.asarray(z["mean"])
    else:
        dec_w = jnp.asarray(cs.get_array("weights"))
        mean = jnp.asarray(cs.get_array("mean"))
    h, w = padded_shape[:2]
    coeff = blocks_of(coeff_img, b)
    blocks = jnp.dot(coeff, dec_w.T, precision=jax.lax.Precision.HIGHEST) + mean
    ct = unblocks_of(blocks, h, w, 3, b)
    y = inv(ct) + soff
    y = dct_ops.unpad_centered(y, shape)
    return np.asarray(jnp.clip(jnp.round(y), 0, 255)).astype(np.uint8)
