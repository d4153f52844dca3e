"""Vector quantization via k-means on device.

Capability parity with src/VQ.py (spatial block VQ) and src/color-VQ.py
(RGB palette VQ), which use scikit-learn KMeans (`k-means++`, n_init=1,
unseeded — the reference is nondeterministic here, SURVEY §7.3; we fix
a seed so codestreams are reproducible).

Device k-means: distance computation is a single matmul per Lloyd
iteration (``|x-c|^2 = |x|^2 - 2 x.c + |c|^2``) over all points at
once — matmul work — and centroid update is a segment-sum via one-hot
matmul.  k-means++ seeding uses jax.random with a fixed key.

Centroids are energy-sorted with a label remap like the reference
(src/VQ.py:87-100), so label images are stable under centroid
permutation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _pairwise_sqdist(x: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """(N, D), (K, D) -> (N, K) squared distances via matmul."""
    x2 = jnp.sum(x * x, axis=1, keepdims=True)
    c2 = jnp.sum(c * c, axis=1)[None, :]
    xc = jnp.dot(x, c.T, precision=jax.lax.Precision.HIGHEST)
    return x2 - 2.0 * xc + c2


def kmeans_plus_plus_init(key, x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Standard k-means++ seeding (D^2 sampling), deterministic by key.

    Seeding runs on a <=16384-point stride subsample (r5): the k
    sequential D^2 passes were ~2/3 of the whole kmeans wall at 512^2
    inputs, and seeding quality is statistically identical on a
    uniform subsample (the Lloyd iterations still see every point)."""
    n_full = x.shape[0]
    if n_full > 16384:
        x = x[:: -(-n_full // 16384)]
    n = x.shape[0]
    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers0 = jnp.zeros((k, x.shape[1]), x.dtype).at[0].set(x[first])

    def body(i, state):
        centers, d2, key = state
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(jnp.sum(d2), 1e-30)
        idx = jax.random.categorical(sub, jnp.log(jnp.maximum(probs, 1e-30)))
        c_new = x[idx]
        centers = centers.at[i].set(c_new)
        d2_new = jnp.sum((x - c_new) ** 2, axis=1)
        return centers, jnp.minimum(d2, d2_new), key

    d2 = jnp.sum((x - centers0[0]) ** 2, axis=1)
    centers, _, _ = jax.lax.fori_loop(1, k, body, (centers0, d2, key))
    return centers


@functools.partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(key, x: jnp.ndarray, k: int, iters: int = 25,
           init_centers=None):
    """Lloyd's k-means.  x: (N, D) float32.  Returns (centroids (K, D),
    labels (N,) int32), centroids energy-sorted ascending.
    `init_centers` overrides the k-means++ seeding (used by the sharded
    trainer's exactness tests)."""
    x = x.astype(jnp.float32)
    centers = (kmeans_plus_plus_init(key, x, k) if init_centers is None
               else init_centers.astype(jnp.float32))

    def step(_, centers):
        d2 = _pairwise_sqdist(x, centers)
        assign = jnp.argmin(d2, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # (N, K)
        mass = onehot.sum(axis=0)  # (K,)
        sums = jnp.dot(onehot.T, x, precision=jax.lax.Precision.HIGHEST)  # (K, D)
        new = jnp.where(mass[:, None] > 0, sums / jnp.maximum(mass[:, None], 1.0), centers)
        return new

    centers = jax.lax.fori_loop(0, iters, step, centers)

    # energy-sort centroids (reference: src/VQ.py:87-100 sorts by energy
    # and remaps labels through a LUT)
    energy = jnp.sum(centers.astype(jnp.float32) ** 2, axis=1)
    order = jnp.argsort(energy)
    centers = centers[order]
    labels = jnp.argmin(_pairwise_sqdist(x, centers), axis=1).astype(jnp.int32)
    return centers, labels


def assign_labels(x: jnp.ndarray, centers: jnp.ndarray) -> jnp.ndarray:
    """Nearest-centroid assignment (decode-side helper and re-encode)."""
    return jnp.argmin(_pairwise_sqdist(x.astype(jnp.float32), centers), axis=1).astype(
        jnp.int32
    )


# ---------------------------------------------------------------------------
# Block packing for spatial VQ (src/VQ.py: non-overlapping BSxBSxC blocks)
# ---------------------------------------------------------------------------

def image_to_blocks(img: jnp.ndarray, bs: int) -> jnp.ndarray:
    """(H, W, C) -> (H//bs * W//bs, bs*bs*C); H, W % bs == 0."""
    h, w, c = img.shape
    x = img.reshape(h // bs, bs, w // bs, bs, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return x.reshape(-1, bs * bs * c)


def blocks_to_image(blocks: jnp.ndarray, h: int, w: int, bs: int, c: int) -> jnp.ndarray:
    x = blocks.reshape(h // bs, w // bs, bs, bs, c)
    x = x.transpose(0, 2, 1, 3, 4)
    return x.reshape(h, w, c)


# ---------------------------------------------------------------------------
# Data-parallel k-means over a device mesh (BASELINE north star: ONE
# shared codebook trained across shards, broadcast to all — the
# reference trains one codebook per image, src/VQ.py:110-112; here the
# per-iteration sufficient statistics (assignment mass and sums) are
# psum'd so every device holds identical centroids at every step)
# ---------------------------------------------------------------------------

def kmeans_sharded(key, x, k: int, mesh, axis: str = "data",
                   iters: int = 25):
    """k-means with the data axis sharded over `mesh`.

    x: (N, D) global array (N divisible by the mesh size).  Returns
    (centroids (K, D) replicated, labels (N,)) — numerically identical
    to `kmeans(..., init_centers=same_init)` on the unsharded data
    (psum of per-shard (mass, sums) == global sums; pinned by
    tests/test_parallel.py).  Seeding: k-means++ over a deterministic
    global subsample (identical regardless of the mesh size).
    """
    import numpy as _np
    from jax.sharding import NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    x_np = _np.asarray(x, _np.float32)
    n = x_np.shape[0]
    stride = max(1, n // max(8 * k, 1))
    sub = jnp.asarray(x_np[::stride])
    init = kmeans_plus_plus_init(key, sub, k)

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(axis), P()),
        out_specs=(P(), P(axis)), check_vma=False)
    def run(xs, centers):
        def step(_, c):
            d2 = _pairwise_sqdist(xs, c)
            assign = jnp.argmin(d2, axis=1)
            onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)
            mass = jax.lax.psum(onehot.sum(axis=0), axis)
            sums = jax.lax.psum(
                jnp.dot(onehot.T, xs,
                        precision=jax.lax.Precision.HIGHEST), axis)
            return jnp.where(mass[:, None] > 0,
                             sums / jnp.maximum(mass[:, None], 1.0), c)

        centers = jax.lax.fori_loop(0, iters, step, centers)
        energy = jnp.sum(centers ** 2, axis=1)
        order = jnp.argsort(energy)
        centers = centers[order]
        labels = jnp.argmin(_pairwise_sqdist(xs, centers),
                            axis=1).astype(jnp.int32)
        return centers, labels

    xd = jax.device_put(x_np, NamedSharding(mesh, P(axis)))
    centers, labels = run(xd, init)
    return (_np.asarray(jax.device_get(centers)),
            _np.asarray(jax.device_get(labels)), _np.asarray(init))
