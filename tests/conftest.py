"""Test configuration.

The suite runs on the CPU with 8 virtual devices, so the sharding tests
exercise real multi-device code paths.  Tests that need the card carry
the `gpu` marker and skip on the CPU; on a machine with a GPU, keep
JAX's own platform and run them with

    VCF_TEST_GPU=1 python -m pytest tests/ -m gpu -p no:xdist
"""

import os

ON_GPU = os.environ.get("VCF_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from vcf_tpu.io.images import test_image


@pytest.fixture(scope="session")
def img512():
    return test_image(512, 512)


@pytest.fixture(scope="session")
def img_small():
    return test_image(64, 48, seed=3)


@pytest.fixture(scope="session")
def img_odd():
    """Non-multiple-of-block-size dimensions to exercise padding."""
    return test_image(61, 45, seed=11)
