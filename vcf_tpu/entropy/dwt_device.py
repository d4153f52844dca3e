"""Device (one-dispatch) grouped-rANS entropy for the DWT pipeline.

The reference writes one host stream per subband
(/root/reference/src/2D-DWT.py:162-200); r4's vcf_tpu did the same,
which left the DWT+entropy configs at host speed (VERDICT r4 missing
#1: 0.0008 GB/s — 16 host codec calls plus a per-band quantize
dispatch each).  Here the whole entropy stage is device-resident and
ONE logical dispatch each way:

* Every subband becomes one rANS GROUP with its own probability table
  (the per-band statistics the reference's per-band streams capture).
  The LL band is 16-bit and becomes TWO groups (hi/lo byte planes).
* All groups get the same lane count `sg` (a power of two); short
  bands pad with the deadzone zero symbol, whose cost is ~0
  bits/symbol under the band's own table.
* The encode runs `rans.encode_grouped` (the encode-scan kernel where
  `ops.pallas.use_encode_kernel` admits the shape, the XLA scan
  elsewhere: identical streams); the decode is the XLA grouped scan.

Wire format (sidecar ``gdwt_model``): u8 version | u32 G | u32 sg |
u32 L | u32 n_words | u32 qss | states (S u32) | u32 counts_zlib_len |
zlib(u32 per-step renorm counts) | zlib(u16 freqs[G*256]).  Band
shapes ride in the pipeline's meta JSON.
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from vcf_tpu.entropy import rans as rans_mod
from vcf_tpu.ops import hist as hist_ops

K_PROB = rans_mod.K_PROB


def grid_dims(band_sizes: Sequence[int],
              syms_per_lane: int = 512) -> Tuple[int, int]:
    """(sg, L) for the uniform lane grid.  Lane count targets
    `syms_per_lane` symbols per lane over the whole image (512 keeps
    the 4-byte final-state sidecar under ~0.07 bits/symbol, same rule
    as RANSCodec._pick_streams; 256 halves the scan length at ~+0.07
    bpp); sg is a power of two and L a multiple of 4."""
    n_total = sum(band_sizes)
    n_max = max(band_sizes)
    g = len(band_sizes)
    target = max(8, n_total // syms_per_lane // g)
    sg = 1 << int(np.floor(np.log2(target)))
    l = -(-n_max // sg)
    l = -(-l // 4) * 4
    return sg, l


def _band_to_lanes(flat_u8: jnp.ndarray, sg: int, l: int) -> jnp.ndarray:
    """(n,) u8 -> (sg, L) lane block, padded with 128 (deadzone zero).

    Lane-MAJOR: lane j codes the contiguous raster span
    flat[j*L : (j+1)*L], so a lane's previous symbol is the spatially
    adjacent coefficient — the order-1 context the ctx tables condition
    on (r5; order-0 rate is order-invariant)."""
    n = flat_u8.shape[0]
    pad = sg * l - n
    filled = jnp.concatenate(
        [flat_u8, jnp.full((pad,), 128, jnp.uint8)])
    return filled.reshape(sg, l)


def _lanes_to_band(block: jnp.ndarray, n: int) -> jnp.ndarray:
    """(sg, L) -> first n symbols in the _band_to_lanes order."""
    return block.reshape(-1)[:n]


def bands_to_grid(bands_u8: List[jnp.ndarray], sg: int, l: int) -> jnp.ndarray:
    """List of flat u8 bands -> (G*sg, L) grouped lane grid."""
    return jnp.concatenate(
        [_band_to_lanes(b.reshape(-1), sg, l) for b in bands_u8], axis=0)


def grid_to_bands(lanes: jnp.ndarray, sizes: Sequence[int],
                  sg: int) -> List[jnp.ndarray]:
    out = []
    for i, n in enumerate(sizes):
        out.append(_lanes_to_band(lanes[i * sg:(i + 1) * sg], n))
    return out


@functools.partial(jax.jit, static_argnames=("g",))
def _group_counts(lanes: jnp.ndarray, g: int) -> jnp.ndarray:
    return jax.vmap(lambda row: hist_ops.histogram(row, 256))(
        lanes.reshape(g, -1).astype(jnp.int32))


def train_tables(lanes: jnp.ndarray,
                 g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-group quantized freq/cum tables from the data itself (the
    scatter-free device histogram; quantize_freqs on host — the tables
    are codestream side info either way)."""
    counts_h = np.asarray(_group_counts(lanes, g))
    fg = np.stack([
        rans_mod.quantize_freqs(counts_h[i], min_all=True)
        for i in range(g)
    ]).astype(np.uint32)
    cg = np.concatenate(
        [np.zeros((g, 1), np.uint32),
         np.cumsum(fg, axis=1)[:, :255].astype(np.uint32)], axis=1)
    return fg, cg


def encode_grid(lanes: jnp.ndarray, fg: np.ndarray, cg: np.ndarray
                ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """(S, L) u8 lanes -> (words u16, n_words, states u32, counts i32)."""
    words, n_words, st, counts = rans_mod.encode_grouped(
        lanes, jnp.asarray(fg), jnp.asarray(cg))
    n = int(n_words)
    return (rans_mod.words_to_host(words, n), n,
            np.asarray(st), np.asarray(counts, np.int64))


def decode_grid(words: np.ndarray, states: np.ndarray, fg: np.ndarray,
                cg: np.ndarray, l: int) -> jnp.ndarray:
    """Inverse of encode_grid -> (S, L) u8 lanes on device."""
    unroll = next(u for u in (4, 3, 2, 1) if l % u == 0)
    wpad = jnp.asarray(rans_mod.pad_words(words, states.size + 16))
    return rans_mod.jax_decode_hier(
        wpad, jnp.int32(0), jnp.asarray(states), jnp.asarray(fg),
        jnp.asarray(cg), l, unroll=unroll)


# ---------------------------------------------------------------------------
# Order-1 context variant (r5): per-(band, prev-symbol-class) tables.
# The lane-major raster layout makes each lane's previous symbol the
# spatially adjacent coefficient — exactly the run structure that kept
# order-0 grans ~0.9 bpp above zlib on DWT detail bands.
# ---------------------------------------------------------------------------

def train_ctx_tables(lanes: jnp.ndarray, g: int,
                     n_ctx: int) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.asarray(rans_mod.ctx_group_histograms(lanes, g, n_ctx))
    return rans_mod.ctx_freqs_from_counts(counts)


def encode_grid_ctx(lanes: jnp.ndarray, fgc: np.ndarray, cgc: np.ndarray):
    """(S, L) u8 lanes + (G, n_ctx, 256) tables -> same wire tuple as
    encode_grid, coded with the order-1 context scan."""
    words, n_words, st, counts = rans_mod.jax_encode_ctx(
        lanes, jnp.asarray(fgc), jnp.asarray(cgc))
    n = int(n_words)
    return (rans_mod.words_to_host(words, n), n, np.asarray(st),
            np.asarray(counts, np.int64))


def decode_grid_ctx(words: np.ndarray, states: np.ndarray, fgc: np.ndarray,
                    cgc: np.ndarray, l: int) -> jnp.ndarray:
    wpad = jnp.asarray(rans_mod.pad_words(words, states.size + 16))
    return rans_mod.jax_decode_ctx(wpad, jnp.asarray(states),
                                   jnp.asarray(fgc), jnp.asarray(cgc), l)


# ---------------------------------------------------------------------------
# Sidecar serialization
# ---------------------------------------------------------------------------

def pack_model(g: int, sg: int, l: int, n_words: int, qss: int,
               states: np.ndarray, counts: np.ndarray,
               fg: np.ndarray, n_ctx: int = 0) -> bytes:
    """n_ctx == 0: order-0 (version 1, fg (G, 256)); n_ctx > 0:
    order-1 context (version 2, fg (G, n_ctx, 256))."""
    counts_z = zlib.compress(counts.astype("<u4").tobytes(), 6)
    ver = 2 if n_ctx else 1
    head = struct.pack("<BIIIII", ver, g, sg, l, n_words, qss)
    if n_ctx:
        head += struct.pack("<B", n_ctx)
    return (head
            + states.astype("<u4").tobytes()
            + struct.pack("<I", len(counts_z)) + counts_z
            + zlib.compress(fg.astype("<u2").tobytes(), 9))


def unpack_model(blob: bytes):
    ver, g, sg, l, n_words, qss = struct.unpack_from("<BIIIII", blob, 0)
    if ver not in (1, 2):
        raise ValueError(f"gdwt_model version {ver}")
    off = 21
    n_ctx = 0
    if ver == 2:
        (n_ctx,) = struct.unpack_from("<B", blob, off)
        off += 1
    s = g * sg
    states = np.frombuffer(blob, "<u4", s, off).copy()
    off += 4 * s
    (clen,) = struct.unpack_from("<I", blob, off)
    off += 4
    counts = np.frombuffer(zlib.decompress(blob[off:off + clen]), "<u4"
                           ).astype(np.int64)
    off += clen
    raw = np.frombuffer(zlib.decompress(blob[off:]), "<u2"
                        ).astype(np.uint32)
    if n_ctx:
        fg = raw.reshape(g, n_ctx, 256)
        cg = np.concatenate(
            [np.zeros((g, n_ctx, 1), np.uint32),
             np.cumsum(fg, axis=2)[:, :, :255].astype(np.uint32)], axis=2)
    else:
        fg = raw.reshape(g, 256)
        cg = np.concatenate(
            [np.zeros((g, 1), np.uint32),
             np.cumsum(fg, axis=1)[:, :255].astype(np.uint32)], axis=1)
    return g, sg, l, n_words, qss, states, counts, fg, cg, n_ctx
