"""Interleaved-rANS encode scan as one Pallas program per block of lanes,
compiled through Triton.

The encode's sequential phase is lane-local: lane s advances its own
32-bit state over its own L symbols and records, per step, the low 16
bits of the state and whether that step renormalized
(`entropy.rans._scan_grouped_xla`).  The XLA version is a `lax.scan`
of L steps with several small kernels per step.  Here each program owns
`block` lanes, keeps their states in registers, runs the L loop inside
the kernel and reads every symbol once.

Contract (identical to the XLA scan, so `entropy.rans._compact_words`
builds the same stream from either):

    syms (S, L) u8, freqs_g / cums_g (G, 256)
      -> lows (L, S) u16, emits (L, S) bool, states (S,) u32

Row i of `lows`/`emits` is the step that codes symbol L-1-i (rANS
encodes in reverse); lane s uses table s // (S // G).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from vcf_tpu.entropy.rans import K_PROB, RANS_L, _SHIFT_EMIT

#: most lanes one program owns (one lane per thread at 4 warps)
MAX_BLOCK = 128
#: fewest lanes worth a program: one warp
MIN_BLOCK = 32


def lane_block(s_streams: int) -> int:
    """Largest power of two that divides `s_streams`, capped at MAX_BLOCK
    (Triton blocks are powers of two; the grid tiles S exactly)."""
    return min(MAX_BLOCK, s_streams & -s_streams)


def _kernel(syms_ref, ftab_ref, ctab_ref, lows_ref, emits_ref, states_ref,
            *, l: int, block: int, sg: int):
    lane0 = pl.program_id(0) * block
    lanes = pl.ds(lane0, block)
    # flat (G*256,) table offset of each lane's group
    base = ((lane0 + jnp.arange(block, dtype=jnp.int32)) // sg) * 256

    def step(i, x):
        sym = syms_ref[l - 1 - i, lanes].astype(jnp.int32)
        f = ftab_ref[base + sym].astype(jnp.uint32)
        cum = ctab_ref[base + sym].astype(jnp.uint32)
        emit = (x >> jnp.uint32(_SHIFT_EMIT)) >= f
        lows_ref[i, lanes] = (x & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        emits_ref[i, lanes] = emit.astype(jnp.uint8)
        x = jnp.where(emit, x >> jnp.uint32(16), x)
        return ((x // f) << jnp.uint32(K_PROB)) + (x % f) + cum

    x0 = jnp.full((block,), RANS_L, jnp.uint32)
    states_ref[lanes] = jax.lax.fori_loop(0, l, step, x0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def encode_scan(syms: jnp.ndarray, freqs_g: jnp.ndarray, cums_g: jnp.ndarray,
                interpret: bool = False):
    """See the module docstring.  `interpret=True` runs the kernel with the
    Pallas interpreter (CPU tests); on the card it compiles for the GPU."""
    s_streams, l = syms.shape
    g = freqs_g.shape[0]
    block = lane_block(s_streams)
    kernel = functools.partial(_kernel, l=l, block=block, sg=s_streams // g)
    lows, emits, states = pl.pallas_call(
        kernel,
        grid=(s_streams // block,),
        out_shape=(
            jax.ShapeDtypeStruct((l, s_streams), jnp.uint16),
            jax.ShapeDtypeStruct((l, s_streams), jnp.uint8),
            jax.ShapeDtypeStruct((s_streams,), jnp.uint32),
        ),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="rans_encode_scan",
    )(syms.T, freqs_g.reshape(-1).astype(jnp.int32),
      cums_g.reshape(-1).astype(jnp.int32))
    return lows, emits.astype(bool), states
