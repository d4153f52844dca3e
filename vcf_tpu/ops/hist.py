"""Scatter-free device histograms.

Histograms are computed without scatter-add, as a `lax.scan` of
chunked equality-compare + reduce: per chunk the (chunk, n_bins)
boolean matrix is reduced over the chunk axis — elementwise work with
sequential reads.  Whether `jnp.bincount` is faster on the GPU is
ROADMAP S5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("n_bins", "chunk"))
def histogram(values: jnp.ndarray, n_bins: int, chunk: int = 1 << 18) -> jnp.ndarray:
    """Counts of int values in [0, n_bins); values outside are clipped.

    values: any-shape int array.  Returns (n_bins,) int32.
    """
    flat = jnp.clip(values.reshape(-1).astype(jnp.int32), 0, n_bins - 1)
    n = flat.shape[0]
    chunk = min(chunk, max(n, 1))
    pad = (-n) % chunk
    # pad with n_bins-1 and subtract the pad count at the end
    x = jnp.pad(flat, (0, pad), constant_values=n_bins - 1).reshape(-1, chunk)
    bins = jnp.arange(n_bins, dtype=jnp.int32)

    def body(acc, row):
        eq = row[:, None] == bins[None, :]
        return acc + jnp.sum(eq, axis=0, dtype=jnp.int32), None

    acc, _ = lax.scan(body, jnp.zeros(n_bins, jnp.int32), x)
    return acc.at[n_bins - 1].add(-pad)


@functools.partial(jax.jit, static_argnames=("n_bins", "chunk"))
def histogram_per_channel(values: jnp.ndarray, n_bins: int,
                          chunk: int = 1 << 16) -> jnp.ndarray:
    """(..., C) int values -> (C, n_bins) counts (clipped to range)."""
    c = values.shape[-1]
    flat = values.reshape(-1, c)
    return jax.vmap(lambda ch: histogram(flat[:, ch], n_bins, chunk))(
        jnp.arange(c)
    )
