"""The rANS encode-scan kernel (ops/pallas/rans_scan.py) and the one
predicate that chooses it.

On the CPU the kernel runs in the Pallas interpreter; it must produce
exactly the records of the XLA scan, and through the shared compaction
the same stream as jax_encode_grouped and np_encode_grouped.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest

from vcf_tpu.entropy import rans
from vcf_tpu.ops import pallas
from vcf_tpu.ops.pallas import rans_scan


def _symbols(s, l, g, p, seed):
    """(S, L) u8 lanes around the stored zero 128, geometric magnitudes
    with success probability p (small p = wide, large p = peaked), a
    different spread per group."""
    rng = np.random.default_rng(seed)
    grp = np.arange(s) // (s // g)
    mag = rng.geometric(np.minimum(p + 0.05 * grp, 0.99)[:, None], (s, l)) - 1
    sign = rng.choice([-1, 1], (s, l))
    return np.clip(128 + sign * mag, 0, 255).astype(np.uint8)


def _tables(syms, g, min_all_only=False):
    s = syms.shape[0]
    if min_all_only:       # untrained model: every symbol at the floor
        counts = np.zeros((g, 256), np.int64)
    else:
        counts = np.stack([np.bincount(syms[i * s // g:(i + 1) * s // g]
                                       .ravel(), minlength=256)
                           for i in range(g)])
    return rans.freqs_from_counts(counts)


def _check_parity(syms, fg, cg):
    args = (jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
    lows, emits, states = rans_scan.encode_scan(*args, interpret=True)
    ref = rans._scan_grouped_xla(*args)
    np.testing.assert_array_equal(np.asarray(lows), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(emits), np.asarray(ref[1]))
    np.testing.assert_array_equal(np.asarray(states), np.asarray(ref[2]))
    words, n_words, st, counts = rans._finish_stream(
        lows, emits, states, with_counts=True)
    wx, nx, sx, cx = rans.jax_encode_grouped(*args, with_counts=True)
    wn, sn = rans.np_encode_grouped(syms, fg)
    n = int(n_words)
    assert n == int(nx) == wn.size
    np.testing.assert_array_equal(np.asarray(words)[:n], wn)
    np.testing.assert_array_equal(np.asarray(words)[:n], np.asarray(wx)[:n])
    np.testing.assert_array_equal(np.asarray(st), sn)
    np.testing.assert_array_equal(np.asarray(counts), np.asarray(cx))


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("sg", [32, 64])
@pytest.mark.parametrize("l", [1, 9, 40])
def test_kernel_matches_xla_scan(g, sg, l):
    syms = _symbols(g * sg, l, g, p=0.3, seed=g * 100 + sg + l)
    _check_parity(syms, *_tables(syms, g))


@pytest.mark.parametrize("p", [0.02, 0.5, 0.97])
def test_kernel_skewed_distributions(p):
    """Near-uniform, peaked and near-deterministic planes (the last one
    renormalizes rarely, the first almost every step)."""
    syms = _symbols(256, 24, 4, p=p, seed=int(p * 100))
    _check_parity(syms, *_tables(syms, 4))


@pytest.mark.parametrize("g", [1, 4])
def test_kernel_minimum_frequency_tables(g):
    """Every symbol at the min_all floor except where training put
    mass: symbols of frequency 1 take the largest state steps."""
    syms = _symbols(128, 16, g, p=0.1, seed=7)
    fg, cg = _tables(syms, g, min_all_only=True)
    _check_parity(syms, fg, cg)
    # a table trained on other data: most coded symbols are at the floor
    other = np.full_like(syms, 128)
    _check_parity(syms, *_tables(other, g))


@pytest.mark.parametrize("s,block", [(8, 8), (96, 32), (128, 128),
                                     (8704, 128), (65536, 128), (40, 8)])
def test_lane_block(s, block):
    assert rans_scan.lane_block(s) == block


@pytest.mark.parametrize("platform,s,chosen", [
    ("gpu", 65536, True), ("gpu", 8704, True), ("gpu", 96, True),
    ("gpu", 40, False), ("gpu", 8, False),
    ("cpu", 65536, False), ("tpu", 65536, False), ("rocm", 65536, False),
])
def test_use_encode_kernel(platform, s, chosen):
    assert pallas.use_encode_kernel(s, platform) is chosen


def test_use_encode_kernel_reads_the_backend():
    assert pallas.use_encode_kernel(65536) is False  # the suite runs on CPU


@pytest.fixture
def kernel_forced(monkeypatch):
    """Route the codecs through the kernel (interpreted) on the CPU."""
    calls = []
    interpreted = functools.partial(rans_scan.encode_scan, interpret=True)

    def encode_scan(*args):
        calls.append(args[0].shape)
        return interpreted(*args)

    monkeypatch.setattr(pallas, "use_encode_kernel",
                        lambda s_streams, platform=None: True)
    monkeypatch.setattr(rans_scan, "encode_scan", encode_scan)
    rans._encode_grouped.clear_cache()
    yield calls
    rans._encode_grouped.clear_cache()


@pytest.mark.parametrize("name", ["rans", "grans"])
def test_codecs_route_through_the_kernel(name, kernel_forced):
    from vcf_tpu import entropy
    from vcf_tpu.io import test_image

    planes = test_image(128, 128, seed=2)[None]
    codec = entropy.get(name)
    payload, side = codec.encode(planes)
    back = codec.decode(payload, side)
    assert kernel_forced, "the kernel was not traced"
    np.testing.assert_array_equal(back, planes)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "use_encode_kernel",
                   lambda s_streams, platform=None: False)
        assert codec.encode(planes) == (payload, side)


def test_dwt_grid_routes_through_the_kernel(kernel_forced):
    from vcf_tpu.entropy import dwt_device as dd

    syms = _symbols(3 * 64, 12, 3, p=0.4, seed=3)
    fg, cg = _tables(syms, 3)
    words, n, states, counts = dd.encode_grid(jnp.asarray(syms), fg, cg)
    assert kernel_forced == [syms.shape]
    wn, sn = rans.np_encode_grouped(syms, fg)
    np.testing.assert_array_equal(words, wn)
    np.testing.assert_array_equal(states, sn)
    back = dd.decode_grid(words, states, fg, cg, 12)
    np.testing.assert_array_equal(np.asarray(back), syms)
