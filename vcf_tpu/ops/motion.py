"""Block motion estimation / compensation (device-side).

Capability parity with the reference's IPP motion tools
(src/IPP_DCT.py): full-search SAD over a +-S window with MxM blocks
(:225-244), optional three-step fast search (:159-204), and motion
compensation with boundary clamping (:378-395).

Device design: the reference parallelizes over block rows with a
thread pool (:360-368); here the whole search is one vectorized
program — for every displacement d in the (2S+1)^2 window, the SAD of
*all* blocks against the shifted reference is an elementwise |a-b|
over the full frame followed by a per-block reduction, so the search
is a `lax.map` over displacements of fused VPU work, with an argmin at
the end.  No gathers, no Python loops over blocks.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp


def to_luma(frame: jnp.ndarray) -> jnp.ndarray:
    """uint8 RGB (H, W, 3) -> float32 luma, BT.601 weights like
    cv2.cvtColor(..., COLOR_RGB2GRAY) used at src/IPP_DCT.py:350-352."""
    w = jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    return jnp.einsum("hwc,c->hw", frame.astype(jnp.float32), w,
                      precision=jax.lax.Precision.HIGHEST)


def _block_reduce_sum(x: jnp.ndarray, m: int) -> jnp.ndarray:
    h, w = x.shape
    return x.reshape(h // m, m, w // m, m).sum(axis=(1, 3))


@functools.partial(jax.jit, static_argnames=("m", "s"))
def full_search(ref_luma: jnp.ndarray, cur_luma: jnp.ndarray, m: int, s: int):
    """Full-search block ME.  Returns (mv (nby, nbx, 2) int32 with
    (dy, dx), sad (nby, nbx) float32 of the winner).

    Ties resolve to the first candidate in row-major (dy, dx) order with
    the smallest SAD — deterministic.
    """
    h, w = cur_luma.shape
    ref_pad = jnp.pad(ref_luma, ((s, s), (s, s)), mode="edge")

    def sad_for(d):
        dy, dx = d
        shifted = jax.lax.dynamic_slice(ref_pad, (dy + s, dx + s), (h, w))
        return _block_reduce_sum(jnp.abs(cur_luma - shifted), m)

    disp = jnp.stack(
        jnp.meshgrid(
            jnp.arange(-s, s + 1), jnp.arange(-s, s + 1), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 2)  # (D, 2) row-major (dy, dx)
    sads = jax.lax.map(sad_for, disp)  # (D, nby, nbx)
    best = jnp.argmin(sads, axis=0)  # first minimum wins
    mv = disp[best]  # (nby, nbx, 2)
    best_sad = jnp.min(sads, axis=0)
    return mv.astype(jnp.int32), best_sad


@functools.partial(jax.jit, static_argnames=("m", "s"))
def three_step_search(ref_luma: jnp.ndarray, cur_luma: jnp.ndarray, m: int, s: int):
    """Three-step search (src/IPP_DCT.py:159-204): step sizes s/2, s/4,
    ... evaluating the 3x3 neighborhood around the current best at each
    scale.  Vectorized over blocks; the 9 candidates per step are a
    `lax.map`."""
    h, w = cur_luma.shape
    nby, nbx = h // m, w // m
    ref_pad = jnp.pad(ref_luma, ((s, s), (s, s)), mode="edge")
    blocks = cur_luma.reshape(nby, m, nbx, m).transpose(0, 2, 1, 3)

    by = jnp.arange(nby) * m
    bx = jnp.arange(nbx) * m
    base_y = jnp.broadcast_to(by[:, None], (nby, nbx))
    base_x = jnp.broadcast_to(bx[None, :], (nby, nbx))

    def sad_at(dy, dx):
        """SAD of every block vs ref shifted per-block by (dy, dx) maps."""
        def one(yy, xx, d_y, d_x, blk):
            patch = jax.lax.dynamic_slice(
                ref_pad, (yy + s + d_y, xx + s + d_x), (m, m)
            )
            return jnp.sum(jnp.abs(blk - patch))

        return jax.vmap(
            jax.vmap(one, in_axes=(0, 0, 0, 0, 0)), in_axes=(0, 0, 0, 0, 0)
        )(base_y, base_x, dy, dx, blocks)

    neigh = jnp.stack(
        jnp.meshgrid(jnp.arange(-1, 2), jnp.arange(-1, 2), indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)

    mv = jnp.zeros((nby, nbx, 2), jnp.int32)
    step = max(s // 2, 1)
    while True:
        cands = mv[None] + neigh[:, None, None, :] * step  # (9, nby, nbx, 2)
        cands = jnp.clip(cands, -s, s)
        sads = jax.lax.map(
            lambda c: sad_at(c[..., 0], c[..., 1]), cands
        )  # (9, nby, nbx)
        best = jnp.argmin(sads, axis=0)
        mv = jnp.take_along_axis(
            cands, best[None, :, :, None], axis=0
        )[0]
        if step == 1:
            break
        step //= 2
    final_sad = sad_at(mv[..., 0], mv[..., 1])
    return mv, final_sad


@functools.partial(jax.jit, static_argnames=("m", "pad"))
def compensate(ref: jnp.ndarray, mv: jnp.ndarray, m: int, pad: int = 64) -> jnp.ndarray:
    """Motion-compensate a reference frame (H, W, C) with per-block
    integer MVs (nby, nbx, 2); out-of-frame samples clamp to the edge
    (src/IPP_DCT.py:378-395 boundary fallback).  `pad` must be >= the
    search range the MVs came from."""
    h, w, c = ref.shape
    nby, nbx = mv.shape[:2]
    ref_pad = jnp.pad(ref, ((pad, pad), (pad, pad), (0, 0)), mode="edge")

    by = jnp.arange(nby) * m
    bx = jnp.arange(nbx) * m

    def one(yy, xx, d):
        return jax.lax.dynamic_slice(
            ref_pad, (pad + yy + d[0], pad + xx + d[1], 0), (m, m, c)
        )

    patches = jax.vmap(
        jax.vmap(one, in_axes=(None, 0, 0)), in_axes=(0, None, 0)
    )(by, bx, mv)  # (nby, nbx, m, m, c)
    return patches.transpose(0, 2, 1, 3, 4).reshape(h, w, c)
