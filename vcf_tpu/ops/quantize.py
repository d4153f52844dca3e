"""Scalar quantizers (device-side): deadzone and Lloyd-Max.

Capabilities of the reference's `scalar_quantization` package
(used at src/deadzone.py:10,64 and src/LloydMax.py:14,102-113):

* Deadzone: uniform mid-tread quantizer with a doubled zero bin —
  ``k = trunc(x / qss)`` (truncation toward zero), ``y = k * qss``
  (SURVEY §2.2 call-site contract).
* Lloyd-Max: per-channel optimal scalar quantizer seeded from the
  image's own histogram (Laplace-smoothed, reference:
  src/LloydMax.py:96-101) and refined by Lloyd iterations; the decision
  boundaries are midpoints between representation levels and each level
  is the centroid (conditional mean) of its bin.  The representation
  levels are codestream side information (src/LloydMax.py:107-112).

Both are pure jittable functions; Lloyd-Max iteration is a
`lax.fori_loop` over a fixed iteration count so it compiles once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Deadzone
# ---------------------------------------------------------------------------

def deadzone_quantize(x: jnp.ndarray, qss: int) -> jnp.ndarray:
    """k = trunc(x / qss), toward zero (doubled zero bin). int32 output."""
    return jnp.trunc(x.astype(jnp.float32) / qss).astype(jnp.int32)


def deadzone_dequantize(k: jnp.ndarray, qss: int) -> jnp.ndarray:
    """y = k * qss (float32)."""
    return k.astype(jnp.float32) * qss


# ---------------------------------------------------------------------------
# Lloyd-Max
# ---------------------------------------------------------------------------

def lloydmax_levels(qss: int, q_min: int, q_max: int) -> int:
    """Number of representation levels for a nominal step size.

    The reference builds `(max - min + 1) / qss` levels over the support
    (LloydMax_Quantizer(Q_step, counts, min_val, max_val); the histogram has
    `max - min + 1` bins, src/LloydMax.py:96-101)."""
    n = (q_max - q_min + 1) // int(qss)
    return max(2, min(n, 256 * 256))


def lloydmax_histogram(x: jnp.ndarray, q_min: int, q_max: int) -> jnp.ndarray:
    """Per-channel raw counts over the integer support [q_min, q_max].

    x: (..., C) int-valued array.  Returns (C, V) int32 counts, V = the
    support size — the training statistic that is psum'd across shards
    for a shared level set (parallel/dist.allreduce_histogram)."""
    from vcf_tpu.ops.hist import histogram_per_channel

    n_vals = q_max - q_min + 1
    c = x.shape[-1]
    flat = x.reshape(-1, c).astype(jnp.int32)
    return histogram_per_channel(flat - q_min, n_vals)


def lloydmax_train_from_hist(
    hist: jnp.ndarray, qss: int, q_min: int, q_max: int, iters: int = 30
) -> jnp.ndarray:
    """Lloyd iterations from a (C, V) raw-count histogram.

    +1 Laplace smoothing is applied here (reference: src/LloydMax.py:
    96-101), so callers pass raw counts — which makes the statistic
    additive across shards (psum then train == train on the union).
    """
    n_levels = lloydmax_levels(qss, q_min, q_max)
    support = jnp.arange(q_min, q_max + 1, dtype=jnp.float32)  # (V,)
    c = hist.shape[0]
    hist = hist.astype(jnp.float32) + 1.0

    # init: uniform spacing over the support
    init = q_min + (jnp.arange(n_levels, dtype=jnp.float32) + 0.5) * (
        (q_max - q_min + 1) / n_levels
    )
    init = jnp.broadcast_to(init, (c, n_levels))

    def lloyd_step(_, levels):
        # boundaries between adjacent levels: midpoints
        bounds = 0.5 * (levels[:, 1:] + levels[:, :-1])  # (C, L-1)
        # assign every support value to a bin: count of boundaries <= v
        assign = jnp.sum(
            support[None, :, None] >= bounds[:, None, :], axis=-1
        )  # (C, V) in [0, L-1]
        w = hist  # (C, V)
        onehot = jax.nn.one_hot(assign, n_levels, dtype=jnp.float32)  # (C, V, L)
        mass = jnp.einsum("cv,cvl->cl", w, onehot,
                          precision=jax.lax.Precision.HIGHEST)
        moment = jnp.einsum("cv,v,cvl->cl", w, support, onehot,
                            precision=jax.lax.Precision.HIGHEST)
        new = jnp.where(mass > 0, moment / jnp.maximum(mass, 1e-30), levels)
        return new

    levels = jax.lax.fori_loop(0, iters, lloyd_step, init)
    return levels


def lloydmax_train(
    x: jnp.ndarray, qss: int, q_min: int, q_max: int, iters: int = 30
) -> jnp.ndarray:
    """Train per-channel Lloyd-Max representation levels on device.

    x: (..., C) array.  Returns (C, L) float32 levels, sorted ascending.

    The histogram has one bin per integer value in [q_min, q_max] with
    +1 Laplace smoothing (reference: src/LloydMax.py:96-101); levels are
    initialized at uniform bin centers and refined by `iters` Lloyd steps
    computed from the histogram (exact, since the data is integer-valued).
    """
    hist = lloydmax_histogram(x, q_min, q_max)
    return lloydmax_train_from_hist(hist, qss, q_min, q_max, iters)


def lloydmax_quantize(x: jnp.ndarray, levels: jnp.ndarray) -> jnp.ndarray:
    """Map (..., C) values to nearest-level indexes using midpoint bounds.

    levels: (C, L) ascending.  Returns int32 indexes in [0, L-1].
    """
    bounds = 0.5 * (levels[:, 1:] + levels[:, :-1])  # (C, L-1)
    c = x.shape[-1]
    flat = x.reshape(-1, c).astype(jnp.float32)

    def channel_assign(ch):
        return jnp.searchsorted(bounds[ch], flat[:, ch], side="right")

    k = jax.vmap(channel_assign)(jnp.arange(c)).T  # (N, C)
    return k.reshape(x.shape).astype(jnp.int32)


def lloydmax_dequantize(k: jnp.ndarray, levels: jnp.ndarray) -> jnp.ndarray:
    """Look up representation levels: y[..., c] = levels[c, k[..., c]]."""
    c = k.shape[-1]
    flat = k.reshape(-1, c)

    def channel_lookup(ch):
        idx = jnp.clip(flat[:, ch], 0, levels.shape[1] - 1)
        return levels[ch, idx]

    y = jax.vmap(channel_lookup)(jnp.arange(c)).T
    return y.reshape(k.shape).astype(jnp.float32)
