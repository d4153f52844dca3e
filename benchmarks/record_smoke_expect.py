"""Record the CPU values that chip_smoke.py holds the card to.

    python benchmarks/record_smoke_expect.py

Runs the smoke's measured phases (stills, III, IPP, CLI at 1080p) with
JAX on the CPU and writes benchmarks/chip_smoke_expect.json.  Takes a
few minutes and a few GiB of host memory.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    expect = chip_smoke.record_expectations()
    with open(chip_smoke.EXPECT, "w") as f:
        json.dump(expect, f, indent=1)
    print(json.dumps(expect))
