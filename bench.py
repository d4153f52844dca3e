"""Benchmark: encode+decode throughput of the flagship pipeline.

BASELINE.json config 2 at 1080p (8 frames of 1088x1920): YCoCg + 8x8
block DCT + deadzone(32), as a complete codec with the entropy stage on
the device (interleaved rANS, entropy/rans.py), plus the transform
alone and a host-to-host path through the host C++ Huffman coder.

Every time is the host clock around a call that ends in
`block_until_ready`, after warm-up, as the median of REPS calls.  The
script refuses to run without a GPU: a CPU number is not a device
number.

    python bench.py          # prints ONE JSON line
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPS = 5


def build_transform_fns(cfg):
    import jax
    import jax.numpy as jnp
    from vcf_tpu.ops import color as color_ops
    from vcf_tpu.ops import dct as dct_ops
    from vcf_tpu.ops import quantize as q_ops

    b, qss = cfg.block_size, cfg.qss
    fwd, inv = color_ops.get(cfg.color)

    def encode_one(img_u8):
        coeff = dct_ops.analyze(fwd(img_u8.astype(jnp.float32) - 128.0), b)
        k_img = jnp.clip(q_ops.deadzone_quantize(coeff, qss) + 128, 0, 255)
        k_img = k_img.astype(jnp.uint8)
        return dct_ops.to_subbands(k_img, b) if cfg.subbands else k_img

    def decode_one(k_u8):
        k_img = dct_ops.from_subbands(k_u8, b) if cfg.subbands else k_u8
        coeff = q_ops.deadzone_dequantize(k_img.astype(jnp.int32) - 128, qss)
        y = inv(dct_ops.synthesize(coeff, b)) + 128.0
        return jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)

    return jax.vmap(encode_one), jax.vmap(decode_one)


def median_time(fn, *args):
    """Median seconds of REPS calls of fn(*args), after two warm calls."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    from vcf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {jax.devices()}")
    from chip_smoke import card_line

    from vcf_tpu.config import CodecConfig
    from vcf_tpu.entropy import get as get_entropy
    from vcf_tpu.entropy import rans as rans_mod
    from vcf_tpu.io.images import test_image

    n_frames, h, w = 8, 1088, 1920
    frames = np.stack([test_image(h, w, seed=3 + i) for i in range(n_frames)])
    cfg = CodecConfig(entropy="grans")
    enc_t, dec_t = build_transform_fns(cfg)
    b = cfg.block_size
    s_streams = rans_mod.RANSCodec._pick_streams(frames.size, 65536)
    l_steps = frames.size // s_streams
    frames_dev = jax.device_put(frames)

    # per-subband tables, trained on the clip (codestream side info)
    planes0 = np.asarray(jax.jit(enc_t)(frames_dev))
    fg, cg = rans_mod.subband_group_freqs(planes0, b)
    fg_j, cg_j = jnp.asarray(fg), jnp.asarray(cg)

    @jax.jit
    def encode(fd):
        lanes = rans_mod.subband_lanes(enc_t(fd), b, s_streams)
        return rans_mod.encode_grouped(lanes, fg_j, cg_j)

    @jax.jit
    def decode(wpad, states):
        lanes = rans_mod.jax_decode_grouped(
            wpad, jnp.int32(0), states, fg_j, cg_j, l_steps)
        return dec_t(rans_mod.subband_unlanes(lanes, b, frames.shape))

    t_enc = median_time(encode, frames_dev)
    words, n_words, states, counts = encode(frames_dev)
    nw = int(n_words)
    wpad = jnp.concatenate(
        [words[:nw], jnp.zeros((s_streams + 16,), jnp.uint16)])
    t_dec = median_time(decode, wpad, states)
    rec = np.asarray(decode(wpad, states))
    rmse = float(np.sqrt(np.mean(
        (rec.astype(np.float64) - frames) ** 2)))
    bpp = 2 * nw * 8 / (n_frames * h * w)
    device_gbps = frames.nbytes / (t_enc + t_dec) / 1e9

    t_tr = median_time(jax.jit(lambda fd: dec_t(enc_t(fd))), frames_dev)

    # host-to-host: device transform, host C++ Huffman, two frames at a time
    huff = get_entropy("huffman", cfg)
    enc_j, dec_j = jax.jit(enc_t), jax.jit(dec_t)
    chunks = [frames[i: i + 2] for i in range(0, n_frames, 2)]

    def encode_h2h():
        with ThreadPoolExecutor(2) as ex:
            return list(ex.map(lambda c: huff.encode(np.asarray(enc_j(c))),
                               chunks))

    def decode_h2h(payloads):
        with ThreadPoolExecutor(2) as ex:
            return np.concatenate(list(ex.map(
                lambda ps: np.asarray(dec_j(huff.decode(*ps))), payloads)))

    t_he = median_time(encode_h2h)
    payloads = encode_h2h()
    t_hd = median_time(decode_h2h, payloads)
    assert decode_h2h(payloads).shape == frames.shape

    print(json.dumps({
        "metric": "device codec encode+decode GB/s (8x1088x1920, "
                  "DCT+deadzone+grouped rANS, compact stream both ways)",
        "value": round(device_gbps, 4),
        "unit": "GB/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card_line()},
        "detail": {
            "encode_s": t_enc, "decode_s": t_dec,
            "rmse": rmse, "words_bpp": bpp, "frames": n_frames,
            "transform_only_gbps": frames.nbytes / t_tr / 1e9,
            "host_to_host_gbps": frames.nbytes / (t_he + t_hd) / 1e9,
            "timing": f"host clock around block_until_ready, median of "
                      f"{REPS} warm calls",
        },
    }))


if __name__ == "__main__":
    main()
