"""Multi-host distribution: initialization, codebook broadcast, ordered
stream gather.

The reference is single-process (SURVEY §2.4/§5: no MPI/NCCL anywhere);
this module is the new device-native distribution layer prescribed by the
BASELINE north star: frames/GOPs data-parallel over a multi-host
slice, shared side info broadcast once, variable-length compressed
streams gathered to host 0 in frame order.

The tests exercise single-host multi-device execution (8 virtual CPU
devices) and a 2-process jax.distributed run; the multi-host entry
points use the standard `jax.distributed` + global-mesh idioms, so the
same code runs across hosts unchanged.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bring up jax.distributed for a multi-host run (no-op when the
    arguments are absent and JAX env-based autodetection applies)."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every addressable device across all hosts (XLA
    picks the collectives)."""
    return Mesh(np.array(jax.devices()), (axis,))


# ---------------------------------------------------------------------------
# Broadcast of shared side info (codebooks, Lloyd-Max levels, Huffman
# tables): reference analogue is the sidecar files every process reads
# (src/VQ.py:110-112, src/LloydMax.py:107-112).
# ---------------------------------------------------------------------------

def replicate(arr: np.ndarray, mesh: Mesh):
    """Place an array fully replicated on every device of the mesh
    (one broadcast; all shards then quantize against identical tables)."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


def allreduce_histogram(local_counts: jnp.ndarray, mesh: Mesh,
                        axis: str = "data") -> jnp.ndarray:
    """psum of per-shard histograms -> identical global tables on every
    shard (used to train one shared Huffman table / Lloyd-Max levels
    over distributed frames)."""
    from jax import shard_map

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=P(axis), out_specs=P()
    )
    def reduce_fn(counts):
        return jax.lax.psum(counts, axis)

    return reduce_fn(local_counts)


# ---------------------------------------------------------------------------
# Ordered gather of variable-length compressed streams
# ---------------------------------------------------------------------------

def gather_streams(local_streams: Sequence[Tuple[int, bytes]],
                   n_total: int) -> List[bytes]:
    """Gather (frame_index, payload) pairs from every process to host 0
    in frame order (BASELINE: "compressed streams are gathered in frame
    order").

    Single-process: a sort.  Multi-process: each host contributes its
    shard through the jax.experimental.multihost_utils byte-gather; the
    fixed-capacity + actual-length discipline (SURVEY §7.3) handles the
    variable lengths.
    """
    if jax.process_count() == 1:
        out: List[Optional[bytes]] = [None] * n_total
        for idx, blob in local_streams:
            out[idx] = blob
        missing = [i for i, b in enumerate(out) if b is None]
        if missing:
            raise ValueError(f"missing streams for frames {missing[:8]}...")
        return out  # type: ignore[return-value]

    from jax.experimental import multihost_utils

    # fixed-capacity buffers + actual lengths
    cap = max(len(b) for _, b in local_streams)
    cap = int(np.asarray(
        multihost_utils.process_allgather(np.asarray([cap]))).max())
    n_local = len(local_streams)
    idxs = np.asarray([i for i, _ in local_streams], np.int32)
    lens = np.asarray([len(b) for _, b in local_streams], np.int32)
    buf = np.zeros((n_local, cap), np.uint8)
    for row, (_, blob) in enumerate(local_streams):
        buf[row, : len(blob)] = np.frombuffer(blob, np.uint8)
    all_idx = multihost_utils.process_allgather(idxs).reshape(-1)
    all_len = multihost_utils.process_allgather(lens).reshape(-1)
    all_buf = multihost_utils.process_allgather(buf).reshape(-1, cap)
    out = [b"" for _ in range(n_total)]
    for i in range(all_idx.shape[0]):
        out[int(all_idx[i])] = all_buf[i, : int(all_len[i])].tobytes()
    return out
