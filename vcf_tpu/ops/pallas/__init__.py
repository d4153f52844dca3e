"""Hand-written kernels, and the one place that chooses between a kernel
and its plain XLA version.

* rans_scan.encode_scan — the interleaved-rANS encode scan, one Pallas
  program per block of lanes through Triton
  (vcf_tpu/ops/pallas/rans_scan.py).  Plain version:
  `entropy.rans._scan_grouped_xla`; both produce the same records, and
  tests pin the kernel to it in interpret mode.

The choice is derived from the platform and the shape, never set by a
user flag.
"""

from __future__ import annotations

from typing import Optional

import jax


def use_encode_kernel(s_streams: int, platform: Optional[str] = None) -> bool:
    """True where the encode scan runs as the Triton kernel: on a GPU,
    with a lane count that tiles into blocks of at least one warp."""
    from vcf_tpu.ops.pallas.rans_scan import MIN_BLOCK, lane_block

    platform = jax.default_backend() if platform is None else platform
    return platform == "gpu" and lane_block(s_streams) >= MIN_BLOCK
