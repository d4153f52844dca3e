"""Device mesh + sharded batch codec.

Design (SURVEY §7.1 "Sharding model"): mesh axes `("data",)` (one-host)
or `("host", "chip")` (multi-host, flattened to a single data axis for
the frame dimension).  The encode/decode device path is vmapped over
the frame axis and dispatched with `shard_map`, so every chip codes its
own shard of frames with zero collectives; only the final host gather
(device_get of the per-frame index planes, then entropy packing in
frame order) crosses the host boundary.

For quantizers with trained side info (Lloyd-Max levels, VQ codebooks)
the training statistics are reduced across the mesh with `psum` so all
shards quantize against identical, replicated tables — the reference's
"broadcast codebooks once" requirement (BASELINE north star).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vcf_tpu.config import CodecConfig
from vcf_tpu.ops import color as color_ops
from vcf_tpu.ops import dct as dct_ops
from vcf_tpu.ops import quantize as q_ops


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(arr: np.ndarray, mesh: Mesh, axis: str = "data"):
    """Place a batch array with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(arr, sharding)


class BatchCodec:
    """Data-parallel encode/decode of a batch of frames (N, H, W, 3).

    Device work (color transform + block DCT + quantize) runs sharded;
    entropy packing of the per-frame index planes happens on host, per
    frame, preserving order.  Currently supports the DCT/deadzone and
    DCT/Lloyd-Max flows — the benchmark pipelines (BASELINE configs 2).
    """

    def __init__(self, config: CodecConfig, mesh: Optional[Mesh] = None,
                 shared_levels: bool = False):
        if config.spatial != "dct" or config.quantizer not in ("deadzone", "lloydmax"):
            raise NotImplementedError(
                "BatchCodec supports the dct+deadzone/lloydmax flows; "
                "use vcf_tpu.Codec per frame for other compositions"
            )
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = self.mesh.axis_names[0]
        #: lloydmax only — train ONE level set from the psum'd global
        #: histogram (all shards quantize against identical levels, the
        #: reference's one-table-per-source semantics,
        #: src/LloydMax.py:107-112); False trains per-frame levels,
        #: byte-identical to the per-frame `Codec` path.
        self.shared_levels = bool(shared_levels)
        #: side info of the last encode: {"levels": (N, C, L) or (C, L)}
        self.last_qside: dict = {}
        self._build()

    def _build(self):
        cfg = self.config
        b = cfg.block_size
        soff = 128 if cfg.quantizer == "deadzone" else 0
        cname = "ycocg" if cfg.color == "ycocg_r" else cfg.color
        fwd, inv = color_ops.get(cname)
        axis = self.axis

        if cfg.quantizer == "lloydmax":
            self._build_lloydmax(cfg, b, fwd, inv, axis)
            return

        def encode_one(img_u8):
            x = img_u8.astype(jnp.float32) - soff
            ct = fwd(x)
            coeff = dct_ops.analyze(ct, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b)
            if cfg.subbands:
                coeff = dct_ops.to_subbands(coeff, b)
            k = q_ops.deadzone_quantize(coeff, cfg.qss)
            # saturate, not wrap, like pipeline.Codec._store_indexes
            return jnp.clip(k + soff, 0, 255).astype(jnp.uint8)

        def decode_one(k_u8):
            k = k_u8.astype(jnp.int32) - soff
            coeff = q_ops.deadzone_dequantize(k, cfg.qss)
            if cfg.subbands:
                coeff = dct_ops.from_subbands(coeff, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b, inverse=True)
            ct = dct_ops.synthesize(coeff, b)
            y = inv(ct) + soff
            return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)

        spec = P(axis)

        @functools.partial(
            shard_map, mesh=self.mesh, in_specs=(spec,), out_specs=spec)
        def encode_shard(frames):
            return jax.vmap(encode_one)(frames)

        @functools.partial(
            shard_map, mesh=self.mesh, in_specs=(spec,), out_specs=spec)
        def decode_shard(planes):
            return jax.vmap(decode_one)(planes)

        self.encode_device = jax.jit(encode_shard)
        self.decode_device = jax.jit(decode_shard)

    # ------------------------------------------------------------------
    # Lloyd-Max sharded path (VERDICT r3 weak #1 / next #2)
    # ------------------------------------------------------------------
    def _build_lloydmax(self, cfg, b, fwd, inv, axis):
        """Sharded Lloyd-Max: per-frame levels byte-identical to the
        per-frame `Codec` path, or ONE shared level set trained from the
        psum'd global histogram (reference trains one table per source,
        src/LloydMax.py:107-112; here the training statistic is reduced
        across the mesh with `dist.allreduce_histogram`)."""

        def coeff_one(img_u8):
            # identical op order to pipeline.Codec._build_device_fns
            # (soff = 0 for lloydmax, src/2D-DCT.py:107-110)
            x = img_u8.astype(jnp.float32)
            ct = fwd(x)
            coeff = dct_ops.analyze(ct, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b)
            if cfg.subbands:
                coeff = dct_ops.to_subbands(coeff, b)
            return coeff

        train = functools.partial(
            q_ops.lloydmax_train, qss=cfg.qss, q_min=cfg.q_min, q_max=cfg.q_max
        )

        def encode_one(img_u8):
            coeff = coeff_one(img_u8)
            levels = train(jnp.round(coeff).astype(jnp.int32))
            k = q_ops.lloydmax_quantize(coeff, levels)
            return k.astype(jnp.uint8), levels

        def encode_one_shared(img_u8, levels):
            k = q_ops.lloydmax_quantize(coeff_one(img_u8), levels)
            return k.astype(jnp.uint8)

        def hist_one(img_u8):
            return q_ops.lloydmax_histogram(
                jnp.round(coeff_one(img_u8)).astype(jnp.int32),
                cfg.q_min, cfg.q_max,
            )

        def decode_one(k_u8, levels):
            k = k_u8.astype(jnp.int32)
            coeff = q_ops.lloydmax_dequantize(k, levels)
            if cfg.subbands:
                coeff = dct_ops.from_subbands(coeff, b)
            if cfg.perceptual:
                coeff = dct_ops.perceptual_scale(coeff, b, inverse=True)
            ct = dct_ops.synthesize(coeff, b)
            y = inv(ct)
            return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)

        spec = P(axis)
        # check_vma=False: the scan-based histogram carries unvarying
        # zero-init accumulators inside the manual region
        smap = functools.partial(shard_map, mesh=self.mesh, check_vma=False)

        self.encode_device = jax.jit(
            smap(lambda f: jax.vmap(encode_one)(f),
                 in_specs=(spec,), out_specs=(spec, spec))
        )
        self.encode_shared_device = jax.jit(
            smap(lambda f, lv: jax.vmap(encode_one_shared, in_axes=(0, None))(f, lv),
                 in_specs=(spec, P()), out_specs=spec)
        )
        # per-device raw counts summed over the local shard; leading axis
        # kept so dist.allreduce_histogram can psum over the mesh
        self.hist_device = jax.jit(
            smap(lambda f: jnp.sum(jax.vmap(hist_one)(f), axis=0)[None],
                 in_specs=(spec,), out_specs=spec)
        )
        self.decode_device = jax.jit(
            smap(lambda k, lv: jax.vmap(decode_one)(k, lv),
                 in_specs=(spec, spec), out_specs=spec)
        )
        self._lm_train_from_hist = jax.jit(
            functools.partial(
                q_ops.lloydmax_train_from_hist,
                qss=cfg.qss, q_min=cfg.q_min, q_max=cfg.q_max,
            )
        )

    # ------------------------------------------------------------------
    def pad_batch(self, frames: np.ndarray) -> Tuple[np.ndarray, int]:
        """Pad the batch dimension up to a multiple of the mesh size."""
        n = frames.shape[0]
        size = self.mesh.devices.size
        n_pad = (-n) % size
        if n_pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], n_pad, 0)])
        return frames, n

    def encode_planes(self, frames: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) uint8 -> (N, Hp, Wp, 3) uint8 index planes."""
        b = self.config.block_size
        padded = np.stack(
            [np.asarray(dct_ops.pad_centered(jnp.asarray(f, jnp.float32), b)) for f in frames]
        ).astype(np.uint8) if frames.shape[1] % b or frames.shape[2] % b else frames
        batch, n = self.pad_batch(padded)
        x = shard_batch(batch, self.mesh, self.axis)
        if self.config.quantizer == "lloydmax":
            if self.shared_levels:
                from vcf_tpu.parallel import dist

                local = self.hist_device(x)
                ghist = np.asarray(
                    jax.device_get(
                        dist.allreduce_histogram(local, self.mesh, self.axis)
                    )
                )[0]
                levels = np.asarray(self._lm_train_from_hist(jnp.asarray(ghist)))
                lv = dist.replicate(levels, self.mesh)
                planes = np.asarray(jax.device_get(self.encode_shared_device(x, lv)))
                self.last_qside = {"levels": levels}
            else:
                planes_d, levels_d = self.encode_device(x)
                planes = np.asarray(jax.device_get(planes_d))
                self.last_qside = {
                    "levels": np.asarray(jax.device_get(levels_d))[:n]
                }
            return planes[:n]
        planes = np.asarray(jax.device_get(self.encode_device(x)))
        return planes[:n]

    def decode_planes(self, planes: np.ndarray, original_hw=None,
                      qside=None) -> np.ndarray:
        batch, n = self.pad_batch(planes)
        x = shard_batch(batch, self.mesh, self.axis)
        if self.config.quantizer == "lloydmax":
            side = qside if qside is not None else self.last_qside
            levels = np.asarray(side["levels"], np.float32)
            if levels.ndim == 2:  # shared level set -> tile per frame
                levels = np.broadcast_to(
                    levels[None], (planes.shape[0],) + levels.shape
                ).copy()
            lv_batch, _ = self.pad_batch(levels)
            lv = shard_batch(lv_batch, self.mesh, self.axis)
            frames = np.asarray(jax.device_get(self.decode_device(x, lv)))[:n]
        else:
            frames = np.asarray(jax.device_get(self.decode_device(x)))[:n]
        if original_hw is not None and frames.shape[1:3] != tuple(original_hw):
            frames = np.stack(
                [
                    np.asarray(
                        dct_ops.unpad_centered(jnp.asarray(f), tuple(original_hw) + (3,))
                    )
                    for f in frames
                ]
            )
        return frames
