"""Device time of the XLA layers that stand where hand-written kernels
once did: the color + DCT + deadzone transform (BatchCodec's sharded
step, u8 -> u8) at 8x1080x1920, and motion search and compensation per
1088x1920 frame.  Each is the summed device time of its events in a
profiler trace (chip_smoke.device_ms), with the card's name and power
limit.  The transform also gets its share of the bytes roofline: the
u8 frames in and the u8 indexes out at the card's published 3.35 TB/s.

    python benchmarks/xla_layers.py       # needs a GPU
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: NVIDIA H100 SXM, HBM3 (NVIDIA data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def main():
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from vcf_tpu import CodecConfig
    from vcf_tpu.ops import motion
    from vcf_tpu.parallel.mesh import BatchCodec, make_mesh, shard_batch

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU; JAX found {jax.devices()}")
    card = chip_smoke.card_line()
    peak = PEAK_BYTES_PER_S[dev.device_kind]

    frames = chip_smoke.still_frames()
    bc = BatchCodec(CodecConfig(), make_mesh(1))
    x = shard_batch(frames, bc.mesh, bc.axis)
    planes = bc.encode_device(x)
    for name, fn, arg in (("encode", bc.encode_device, x),
                          ("decode", bc.decode_device, planes)):
        ms = chip_smoke.device_ms(fn, arg)
        floor = 2 * frames.nbytes / peak * 1e3    # u8 in + u8 out
        print(f"transform {name} 8x1080x1920: {ms:.3f} ms device; bytes "
              f"floor {floor:.4f} ms, {100 * floor / ms:.2f}% of the bytes "
              f"roofline ({card})")

    clip = chip_smoke.ipp_frames()
    ref = motion.to_luma(jnp.asarray(clip[0]))
    cur = motion.to_luma(jnp.asarray(clip[1]))
    ms = chip_smoke.device_ms(
        jax.jit(lambda r, c: motion.full_search(r, c, 16, 8)), ref, cur)
    print(f"motion.full_search 1088x1920, 16x16 blocks, +-8: {ms:.3f} ms "
          f"device per P-frame ({card})")
    mv, _ = motion.full_search(ref, cur, 16, 8)
    rf = jnp.asarray(clip[0], jnp.float32)
    ms = chip_smoke.device_ms(
        jax.jit(lambda r, m: motion.compensate(r, m, 16, pad=8)), rf, mv)
    print(f"motion.compensate 1088x1920x3: {ms:.3f} ms device per frame "
          f"({card})")
    print(f"mvs nonzero: {float(np.mean(np.any(np.asarray(mv) != 0, -1))):.3f}")


if __name__ == "__main__":
    main()
