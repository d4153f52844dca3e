"""Color transforms (device-side, jittable, channel-last).

Capabilities of the reference's `color_transforms` package (used at
src/YCoCg.py:11-12, src/YCrCb.py:11-12, src/color-DCT.py:11-12):
array-in/array-out per-pixel transforms over the channel axis.

All transforms here are pure functions of a `(H, W, 3)` (or any
`(..., 3)`) array and fuse into surrounding XLA programs.  The matmul
forms keep the channel contraction a matmul when applied to large
batches.

Variants:

* ``ycocg``   — Malvar's scaled YCoCg in float:
                Y = R/4 + G/2 + B/4, Co = (R - B)/2, Cg = (-R + 2G - B)/4.
                Exactly invertible in exact arithmetic; float32 in practice.
* ``ycocg_r`` — lossless lifting YCoCg-R on integers (Co = R - B,
                t = B + (Co >> 1), Cg = G - t, Y = t + (Cg >> 1)); perfectly
                invertible on int dtypes.  Used by integer-only pipelines,
                matching the reference note that YCoCg round-trips
                losslessly on ints (SURVEY §2.2).
* ``ycrcb``   — ITU-R BT.601 full-range float YCrCb (lossy round trip,
                reference: src/video_coding.py:122).
* ``cdct``    — orthonormal DCT-II across the 3 color channels
                (reference: src/color-DCT.py).
* ``none``    — identity.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Matrices (float32).  Channel-last: y = x @ M.T
# ---------------------------------------------------------------------------

YCOCG_FWD = np.array(
    [
        [0.25, 0.50, 0.25],   # Y
        [0.50, 0.00, -0.50],  # Co
        [-0.25, 0.50, -0.25], # Cg
    ],
    dtype=np.float32,
)
YCOCG_INV = np.array(
    [
        [1.0, 1.0, -1.0],  # R = Y + Co - Cg
        [1.0, 0.0, 1.0],   # G = Y + Cg
        [1.0, -1.0, -1.0], # B = Y - Co - Cg
    ],
    dtype=np.float32,
)

# BT.601 full-range YCrCb (as used by e.g. JPEG/OpenCV).  Note the channel
# order is (Y, Cr, Cb) to match cv2 / the reference's YCrCb module name.
_KR, _KG, _KB = 0.299, 0.587, 0.114
YCRCB_FWD = np.array(
    [
        [_KR, _KG, _KB],                      # Y
        [0.5, -0.5 * _KG / (1 - _KR), -0.5 * _KB / (1 - _KR)],  # Cr = (R - Y) * 0.5/(1-Kr)
        [-0.5 * _KR / (1 - _KB), -0.5 * _KG / (1 - _KB), 0.5],  # Cb = (B - Y) * 0.5/(1-Kb)
    ],
    dtype=np.float32,
)
YCRCB_INV = np.linalg.inv(YCRCB_FWD.astype(np.float64)).astype(np.float32)

# Orthonormal DCT-II over the channel axis (N=3); reference: src/color-DCT.py.
def _dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] /= np.sqrt(2.0)
    return m.astype(np.float32)

CDCT_FWD = _dct_matrix(3)
CDCT_INV = CDCT_FWD.T.copy()

# Chroma offsets applied after the forward transform so quantization indexes
# stay in a non-negative range (reference: src/YCoCg.py:28-31: offset
# [0,0,0] for deadzone, [-128,0,0] otherwise; src/color-DCT.py:27-30).
OFFSETS = {
    "ycocg": {"deadzone": (0, 0, 0), "other": (-128, 0, 0)},
    "ycocg_r": {"deadzone": (0, 0, 0), "other": (-128, 0, 0)},
    "ycrcb": {"deadzone": (0, -128, -128), "other": (-128, 0, 0)},
    "cdct": {"deadzone": (0, 128, 128), "other": (0, 128, 128)},
    "none": {"deadzone": (0, 0, 0), "other": (0, 0, 0)},
}


def _apply_matrix(x: jnp.ndarray, m: np.ndarray) -> jnp.ndarray:
    return jnp.einsum(
        "...c,dc->...d",
        x.astype(jnp.float32),
        jnp.asarray(m),
        precision=jax.lax.Precision.HIGHEST,
    )


# ---------------------------------------------------------------------------
# Forward / inverse pairs
# ---------------------------------------------------------------------------

def ycocg_forward(x):
    return _apply_matrix(x, YCOCG_FWD)


def ycocg_inverse(y):
    return _apply_matrix(y, YCOCG_INV)


def ycocg_r_forward(x):
    """Lossless lifting YCoCg-R (integer in, integer out)."""
    x = x.astype(jnp.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return jnp.stack([y, co, cg], axis=-1)


def ycocg_r_inverse(v):
    v = v.astype(jnp.int32)
    y, co, cg = v[..., 0], v[..., 1], v[..., 2]
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = b + co
    return jnp.stack([r, g, b], axis=-1)


def ycrcb_forward(x):
    return _apply_matrix(x, YCRCB_FWD)


def ycrcb_inverse(y):
    return _apply_matrix(y, YCRCB_INV)


def cdct_forward(x):
    return _apply_matrix(x, CDCT_FWD)


def cdct_inverse(y):
    return _apply_matrix(y, CDCT_INV)


def identity(x):
    return x.astype(jnp.float32)


TRANSFORMS = {
    "ycocg": (ycocg_forward, ycocg_inverse),
    "ycocg_r": (ycocg_r_forward, ycocg_r_inverse),
    "ycrcb": (ycrcb_forward, ycrcb_inverse),
    "cdct": (cdct_forward, cdct_inverse),
    "none": (identity, identity),
}


def get(name: str):
    """Return (forward, inverse) for a color-transform name."""
    return TRANSFORMS[name]


def offsets(name: str, quantizer: str) -> np.ndarray:
    key = "deadzone" if quantizer == "deadzone" else "other"
    return np.asarray(OFFSETS[name][key], dtype=np.float32)
