"""Tests that need the card.  They skip elsewhere; on a machine with a
GPU run them with

    VCF_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist

(conftest.py holds the suite on the CPU unless VCF_TEST_GPU=1)."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "colorvq_zlib", "dct_cgrans", "dct_default_tiff", "dct_grans",
    "dct_huffman", "dct_lloydmax_zlib", "dwt_bior44_zlib", "dwt_db5_zlib",
    "dwt_grans", "dwt_sym5_zlib", "ycocg_cbaac"])
def test_golden_on_card(gpu, name):
    """The CPU-made fixtures decode on the card, and re-encode there,
    within the rmse bound of chip_smoke.py (phase 2)."""
    from test_golden import CONFIGS, _input, _paths

    from vcf_tpu import Codec, CodeStream, metrics

    import chip_smoke

    with open(os.path.join(ROOT, "benchmarks",
                           "golden_chip_expect.json")) as f:
        r0 = json.load(f)[name]["rmse"]
    img = _input()
    cfg = CONFIGS[name]
    rec = Codec(cfg).decode(CodeStream.from_file(_paths(name)[0]))
    assert abs(metrics.rmse(img, rec) - r0) <= chip_smoke.RMSE_TOL
    blob = Codec(cfg).encode(img).to_bytes()
    rec2 = Codec(cfg).decode(CodeStream.from_bytes(blob))
    assert abs(metrics.rmse(img, rec2) - r0) <= chip_smoke.RMSE_TOL


@pytest.mark.gpu
def test_encode_kernel_on_card(gpu):
    """The compiled encode-scan kernel against the XLA scan."""
    import jax.numpy as jnp

    from vcf_tpu.entropy import rans
    from vcf_tpu.ops import pallas

    rng = np.random.default_rng(0)
    syms = np.clip(128 + rng.geometric(0.3, (4096, 97)) - 1, 0,
                   255).astype(np.uint8)
    fg, cg = rans.freqs_from_counts(np.stack(
        [np.bincount(syms[i * 64:(i + 1) * 64].ravel(), minlength=256)
         for i in range(64)]))
    args = (jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
    assert pallas.use_encode_kernel(4096)
    got = rans.encode_grouped(*args)
    ref = rans.jax_encode_grouped(*args, with_counts=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
