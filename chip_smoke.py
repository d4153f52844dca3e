#!/usr/bin/env python3
"""Smoke run of the codec on one NVIDIA GPU.

Drives the library's main path once, through the entry points a user
calls, at 1080p with content generated from a seed, and checks every
result against the CPU-recorded values beside this script
(benchmarks/chip_smoke_expect.json, benchmarks/golden_chip_expect.json):

1. device  the card, JAX, the compile cache and the native runtime
2. golden  the CPU-made fixtures in tests/golden/ decode on the card
3. stills  Codec (VCF defaults), Codec dwt+grans and IIICodec grans,
           8 frames of 1080x1920
4. ipp     IPPCodec, one 8-frame GOP of 1088x1920
5. cli     vcf_tpu.cli.main encodes and decodes a 1080p .png, in-process
6. kernel  the rANS encode-scan kernel against the XLA scan and the NumPy
           reference at 8x1088x1920, and the codec's encode timed with each

    python chip_smoke.py          # the phases above, on one card
    python chip_smoke.py --four   # only the sharded paths: a 4-card mesh
                                  # against one card of the same machine

Printed times are smoke timings (host clock around calls that return
host data, median of the warm calls), not the benchmark.  Any failure
exits non-zero and prints no result line.  On success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXPECT = os.path.join(ROOT, "benchmarks", "chip_smoke_expect.json")
GOLDEN_EXPECT = os.path.join(ROOT, "benchmarks", "golden_chip_expect.json")

#: |rmse_card - rmse_cpu| bound.  Transform and quantizer run as float32
#: matmuls at Precision.HIGHEST on both sides, but in another order, so
#: an index that sits on a quantizer decision edge can land +-1 apart; a
#: +-1 index on 0.4% of the coefficients moves the pixel rmse by well
#: under 0.15 even at the 96x112 fixture size.
RMSE_TOL = 0.15
#: |bytes_card / bytes_cpu - 1| bound for the same +-1 edges (the
#: lossless stages are exact, so only the indexes can move the rate)
RATE_TOL = 0.01

N_FRAMES, H, W = 8, 1080, 1920
H_IPP = 1088                     # IPP needs multiples of me_block=16


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit`, the card's name and limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(ts) -> float:
    return float(np.median(ts)) * 1e3


def device_ms(fn, *args, reps: int = 3) -> float:
    """Device time of one call of fn(*args): the summed durations of the
    GPU's events in a profiler trace of `reps` warm calls."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(reps):
                jax.block_until_ready(fn(*args))
        path, = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                          recursive=True)
        planes = jax.profiler.ProfileData.from_file(path).planes
    ns = sum(e.duration_ns for p in planes if p.name.startswith("/device:GPU")
             for line in p.lines for e in line.events)
    return ns / reps / 1e6


def still_frames(h: int = H, w: int = W, n: int = N_FRAMES) -> np.ndarray:
    from vcf_tpu.io.images import test_image

    return np.stack([test_image(h, w, seed=s) for s in range(n)])


# ---------------------------------------------------------------------------
# Measurements (also run on the CPU to record the expected values)
# ---------------------------------------------------------------------------

def run_stills(frames: np.ndarray) -> dict:
    """Per-frame Codec round trips through to_bytes/from_bytes."""
    from vcf_tpu import Codec, CodecConfig, CodeStream, metrics

    out = {}
    for name, cfg in (("dct_default_tiff", CodecConfig()),
                      ("dwt_grans", CodecConfig(spatial="dwt",
                                                entropy="grans"))):
        enc, dec = Codec(cfg), Codec(cfg)
        res = {"rmse": [], "bytes": [], "enc_s": [], "dec_s": []}
        for f in frames:
            t0 = time.perf_counter()
            blob = enc.encode(f).to_bytes()
            t1 = time.perf_counter()
            rec = dec.decode(CodeStream.from_bytes(blob))
            t2 = time.perf_counter()
            res["rmse"].append(metrics.rmse(f, rec))
            res["bytes"].append(len(blob))
            res["enc_s"].append(t1 - t0)
            res["dec_s"].append(t2 - t1)
        out[name] = res
    return out


def run_clip(codec_factory, frames: np.ndarray, reps: int) -> dict:
    """Whole-clip encode -> bytes -> decode, `reps` times."""
    from vcf_tpu import CodeStream, metrics

    res = {"enc_s": [], "dec_s": []}
    enc, dec = codec_factory(), codec_factory()
    for _ in range(reps):
        t0 = time.perf_counter()
        blob = enc.encode(frames).to_bytes()
        t1 = time.perf_counter()
        rec = dec.decode(CodeStream.from_bytes(blob))
        t2 = time.perf_counter()
        res["enc_s"].append(t1 - t0)
        res["dec_s"].append(t2 - t1)
    res["rmse"] = [metrics.rmse(frames, rec)]
    res["bytes"] = [len(blob)]
    return res


def iii_grans():
    from vcf_tpu import CodecConfig
    from vcf_tpu.config import VideoConfig
    from vcf_tpu.video.iii import IIICodec

    return IIICodec(VideoConfig(mode="iii", n_frames=N_FRAMES),
                    CodecConfig(entropy="grans"))


def ipp_default():
    from vcf_tpu import CodecConfig
    from vcf_tpu.config import VideoConfig
    from vcf_tpu.video.ipp import IPPCodec

    return IPPCodec(VideoConfig(mode="ipp", n_frames=N_FRAMES,
                                gop_size=N_FRAMES), CodecConfig())


def ipp_frames() -> np.ndarray:
    from vcf_tpu.io.video import test_video

    return test_video(N_FRAMES, H_IPP, W, seed=7)


def run_cli(img: np.ndarray, reps: int) -> dict:
    """`vcf_tpu.cli.main` encode + decode of a .png, in this process."""
    from vcf_tpu import cli, metrics
    from vcf_tpu.io.images import read_image, write_image

    res = {"enc_s": [], "dec_s": []}
    with tempfile.TemporaryDirectory() as tmp:
        src, enc, dst = (os.path.join(tmp, n)
                         for n in ("in.png", "enc.vcft", "out.png"))
        write_image(src, img)
        for _ in range(reps):
            t0 = time.perf_counter()
            check(cli.main(["encode", "-o", src, "-e", enc]) == 0, "cli encode")
            t1 = time.perf_counter()
            check(cli.main(["decode", "-e", enc, "-d", dst]) == 0, "cli decode")
            t2 = time.perf_counter()
            res["enc_s"].append(t1 - t0)
            res["dec_s"].append(t2 - t1)
        res["rmse"] = [metrics.rmse(img, read_image(dst))]
        res["bytes"] = [os.path.getsize(enc)]
    return res


def record_expectations() -> dict:
    """The values this script checks the card against; run on the CPU
    by benchmarks/record_smoke_expect.py."""
    frames = still_frames()
    out = run_stills(frames)
    out["iii_grans"] = run_clip(iii_grans, frames, reps=1)
    out["ipp"] = run_clip(ipp_default, ipp_frames(), reps=1)
    out["cli"] = run_cli(frames[0], reps=1)
    return {name: {"rmse": r["rmse"], "bytes": r["bytes"]}
            for name, r in out.items()}


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def report(name: str, res: dict, expect: dict, card: str) -> None:
    """Print the smoke timing and hold rmse and size to the CPU values."""
    warm = slice(1, None) if len(res["enc_s"]) > 1 else slice(None)
    print(f"{name}: encode {median_ms(res['enc_s'][warm]):.3f} ms, decode "
          f"{median_ms(res['dec_s'][warm]):.3f} ms (smoke timing, {card})")
    for i, (r, r0, b, b0) in enumerate(zip(res["rmse"], expect["rmse"],
                                           res["bytes"], expect["bytes"])):
        check(abs(r - r0) <= RMSE_TOL,
              f"{name}[{i}] rmse {r:.4f} vs cpu {r0:.4f}")
        check(abs(b / b0 - 1) <= RATE_TOL,
              f"{name}[{i}] {b} bytes vs cpu {b0}")
    print(f"{name}: rmse {np.mean(res['rmse']):.4f} (cpu "
          f"{np.mean(expect['rmse']):.4f}), bytes {sum(res['bytes'])} "
          f"(cpu {sum(expect['bytes'])})")


def np_reference_decode(payload: bytes, side: dict) -> np.ndarray:
    """Decode a `grans` stream with the NumPy reference decoder."""
    from vcf_tpu.entropy import rans

    blob = side["grans_model"]
    if blob[0] == 0:                 # one-table stream (RANSCodec layout)
        body = blob[1:]
        mode, _, _, ndim = struct.unpack_from("<BIIB", body, 0)
        shape = struct.unpack_from(f"<{ndim}I", body, 10)
        b = body[10 + 4 * ndim:]
        check(mode == 0, "u8 stream expected")
        s, l, n, n_words = struct.unpack_from("<IIQI", b, 0)
        states = np.frombuffer(b, "<u4", s, 20)
        freqs = np.frombuffer(zlib.decompress(b[20 + 4 * s:]), "<u2")
        words = np.frombuffer(payload, "<u2", n_words)
        syms = rans.np_decode(words, states, freqs, s, l)
        return syms.T.reshape(-1)[:n].reshape(shape)
    s, l, n_words, ndim = struct.unpack_from("<IIIB", blob, 1)
    shape = struct.unpack_from(f"<{ndim}I", blob, 14)
    off = 14 + 4 * ndim
    off += 4 + struct.unpack_from("<I", blob, off)[0]
    states = np.frombuffer(blob, "<u4", s, off)
    freqs = np.frombuffer(zlib.decompress(blob[off + 4 * s:]), "<u2")
    words = np.frombuffer(payload, "<u2", n_words)
    lanes = rans.np_decode_grouped(words, states, freqs.reshape(64, 256), s, l)
    full = (1,) + tuple(shape) if ndim == 3 else tuple(shape)
    return np.asarray(rans.subband_unlanes(lanes, 8, full)).reshape(shape)


def check_entropy_exact(planes: np.ndarray, codec) -> None:
    """The stage is lossless: the card decodes its stream to the planes
    it encoded, and so does the NumPy reference."""
    payload, side = codec.encode(planes)
    check(np.array_equal(codec.decode(payload, side), planes),
          "device entropy round trip")
    check(np.array_equal(np_reference_decode(payload, side), planes),
          "numpy reference decode of the card's stream")


def check_dwt_lanes_exact(img: np.ndarray) -> None:
    """The DWT device coder decodes its lanes exactly, on the card and
    with the NumPy reference."""
    from vcf_tpu import Codec, CodecConfig
    from vcf_tpu.entropy import dwt_device as dd
    from vcf_tpu.entropy import rans

    codec = Codec(CodecConfig(spatial="dwt", entropy="grans"))
    cs = codec.encode(img)
    g, sg, l, n_words, _, states, _, fg, cg, _ = dd.unpack_model(
        cs["gdwt_model"])
    words = np.frombuffer(cs["gdwt_words"], "<u2", n_words)
    make_lanes = codec._dwt._build_device_fns(codec)[0]
    lanes = np.asarray(make_lanes(img, sg, l))
    check(np.array_equal(
        np.asarray(dd.decode_grid(words, states, fg, cg, l)),
        lanes), "dwt device decode")
    check(np.array_equal(rans.np_decode_grouped(words, states, fg, g * sg, l),
                         lanes), "dwt numpy reference decode")


def phase_device(ctx: dict) -> None:
    import jax

    from vcf_tpu import native
    from vcf_tpu.utils.compile_cache import enable_compile_cache

    ctx["card"] = card_line()
    print(f"card: {ctx['card']}")
    print(f"jax {jax.__version__}, devices {jax.devices()}")
    print(f"compile cache: {enable_compile_cache()}")
    loaded = native.available()
    deflate = "libdeflate" if native.deflate_available() else "zlib module"
    print(f"native entropy runtime loaded: {loaded}; deflate: {deflate}")
    check(loaded, "native entropy runtime did not build or load")


def phase_golden(ctx: dict) -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_golden import CONFIGS, _input, _paths

    from vcf_tpu import Codec, CodeStream, metrics

    with open(GOLDEN_EXPECT) as f:
        expect = json.load(f)
    img = _input()
    for name, cfg in sorted(CONFIGS.items()):
        r0 = expect[name]["rmse"]
        stream = _paths(name)[0]
        rec = Codec(cfg).decode(CodeStream.from_file(stream))
        r = metrics.rmse(img, rec)
        blob = Codec(cfg).encode(img).to_bytes()
        r2 = metrics.rmse(img, Codec(cfg).decode(CodeStream.from_bytes(blob)))
        print(f"golden {name}: decode rmse {r:.4f}, round trip rmse "
              f"{r2:.4f} (cpu {r0}); card stream {len(blob)} bytes, "
              f"recorded {expect[name]['bytes']}")
        check(abs(r - r0) <= RMSE_TOL, f"golden {name} decode rmse {r}")
        check(abs(r2 - r0) <= RMSE_TOL, f"golden {name} round trip rmse {r2}")


def phase_stills(ctx: dict) -> None:
    expect = ctx["expect"]
    frames = still_frames()
    for name, res in run_stills(frames).items():
        report(name, res, expect[name], ctx["card"])
    check_dwt_lanes_exact(frames[0])
    report("iii_grans", run_clip(iii_grans, frames, reps=4),
           expect["iii_grans"], ctx["card"])
    codec = iii_grans()
    check_entropy_exact(codec._batch.encode_planes(frames),
                        codec.still.entropy_codec)


def phase_ipp(ctx: dict) -> None:
    report("ipp", run_clip(ipp_default, ipp_frames(), reps=4),
           ctx["expect"]["ipp"], ctx["card"])


def phase_cli(ctx: dict) -> None:
    report("cli", run_cli(still_frames(n=1)[0], reps=4),
           ctx["expect"]["cli"], ctx["card"])


def phase_kernel(ctx: dict) -> None:
    """Encode-scan kernel vs the XLA scan and the NumPy reference."""
    import jax
    import jax.numpy as jnp

    from vcf_tpu import CodecConfig
    from vcf_tpu.entropy import rans
    from vcf_tpu.ops import pallas
    from vcf_tpu.ops.pallas import rans_scan
    from vcf_tpu.parallel.mesh import BatchCodec, make_mesh

    planes = BatchCodec(CodecConfig(entropy="grans"), make_mesh(1)
                        ).encode_planes(still_frames(h=H_IPP))
    codec = rans.GroupedRANSCodec()
    s = codec.dense._pick_streams(planes.size, codec.n_streams)
    check(codec._groupable(planes) and pallas.use_encode_kernel(s),
          f"kernel path not taken for {planes.shape}")
    lanes = rans.subband_lanes(jnp.asarray(planes), 8, s)
    fg, cg = rans.freqs_from_counts(np.asarray(rans.group_histograms(lanes, 64)))
    args = (lanes, jnp.asarray(fg), jnp.asarray(cg))
    wk, nk, sk, ck = (np.asarray(a) for a in rans.encode_grouped(*args))
    wx, nx, sx, cx = (np.asarray(a) for a in rans.jax_encode_grouped(
        *args, with_counts=True))
    wn, sn = rans.np_encode_grouped(np.asarray(lanes), fg)
    nk = int(nk)
    check(nk == int(nx) == wn.size, f"n_words {nk} {int(nx)} {wn.size}")
    check(np.array_equal(wk[:nk], wx[:nk]) and np.array_equal(wk[:nk], wn),
          "kernel words differ")
    check(np.array_equal(sk, sx) and np.array_equal(sk, sn),
          "kernel states differ")
    check(np.array_equal(ck, cx), "kernel per-step counts differ")
    check(np.array_equal(rans.np_decode_grouped(wk[:nk], sk, fg, s,
                                                lanes.shape[1]),
                         np.asarray(lanes)), "numpy decode of kernel stream")
    print(f"kernel: {lanes.shape[0]} lanes x {lanes.shape[1]} steps, "
          f"{nk} words, byte-identical to jax_encode_grouped and "
          f"np_encode_grouped")

    # the codec's encode with each scan, alternating, in this process
    chooser = pallas.use_encode_kernel
    times = {True: [], False: []}
    payloads = {}
    try:
        for i in range(14):
            kernel = i % 2 == 0
            pallas.use_encode_kernel = chooser if kernel else (
                lambda s_streams, platform=None: False)
            t0 = time.perf_counter()
            payloads[kernel], _ = codec.encode(planes)
            times[kernel].append(time.perf_counter() - t0)
    finally:
        pallas.use_encode_kernel = chooser
    check(payloads[True] == payloads[False], "codec payloads differ")
    tk, tx = median_ms(times[True][1:]), median_ms(times[False][1:])
    print(f"kernel: GroupedRANSCodec.encode {tk:.3f} ms with the kernel, "
          f"{tx:.3f} ms with the XLA scan (median of 6 warm runs each, "
          f"alternating; smoke timing, {ctx['card']})")
    scan_k = device_ms(rans_scan.encode_scan, *args)
    scan_x = device_ms(jax.jit(rans._scan_grouped_xla), *args)
    print(f"kernel: scan phase alone {scan_k:.3f} ms with the kernel, "
          f"{scan_x:.3f} ms with the XLA scan (device time from a profiler "
          f"trace, {ctx['card']})")


def phase_four(ctx: dict, n_frames: int = N_FRAMES, h: int = H,
               w: int = W) -> None:
    """The sharded paths on a 4-device mesh against one device."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from vcf_tpu import CodecConfig
    from vcf_tpu.config import VideoConfig
    from vcf_tpu.entropy import get as get_entropy
    from vcf_tpu.ops import dwt as dwt_ops
    from vcf_tpu.parallel import dist
    from vcf_tpu.parallel.mesh import BatchCodec, make_mesh
    from vcf_tpu.video.ipp import IPPCodec
    from vcf_tpu.io.video import test_video

    check(len(jax.devices()) >= 4, f"need 4 devices, have {jax.devices()}")
    mesh1, mesh4 = make_mesh(1), make_mesh(4)
    frames = still_frames(h=h, w=w, n=n_frames)

    # BatchCodec, frames sharded; per-frame streams gathered in order
    cfg = CodecConfig()
    tiff = get_entropy(cfg.entropy, cfg)
    streams = {}
    for n_dev, mesh in ((4, mesh4), (1, mesh1)):
        planes = BatchCodec(cfg, mesh).encode_planes(frames)
        # each device's shard of frames, listed shard by shard in reverse
        per = n_frames // n_dev
        local = [(i, tiff.encode(planes[i])[0])
                 for d in reversed(range(n_dev))
                 for i in range(d * per, (d + 1) * per)]
        streams[n_dev] = dist.gather_streams(local, n_frames)
    check(streams[4] == streams[1], "BatchCodec streams differ, 4 vs 1")
    print(f"four: BatchCodec {n_frames}x{h}x{w} streams byte-identical "
          f"({sum(map(len, streams[4]))} bytes, gathered in frame order)")

    # Lloyd-Max with one level set from the psum'd histogram
    lm = CodecConfig(quantizer="lloydmax", entropy="zlib")
    out = {}
    for n_dev, mesh in ((4, mesh4), (1, mesh1)):
        bc = BatchCodec(lm, mesh, shared_levels=True)
        planes = bc.encode_planes(frames)
        out[n_dev] = (planes.tobytes(), bc.last_qside["levels"].tobytes())
    check(out[4] == out[1], "shared Lloyd-Max differs, 4 vs 1")
    print("four: shared-levels Lloyd-Max planes and levels byte-identical")

    # GOP-parallel IPP: four GOPs, one per device
    clip = test_video(4 * 4, -(-h // 16) * 16, w, seed=7)
    vcfg = VideoConfig(mode="ipp", n_frames=clip.shape[0], gop_size=4)
    blobs = {n_dev: IPPCodec(vcfg, cfg, mesh=mesh).encode(clip).to_bytes()
             for n_dev, mesh in ((4, mesh4), (1, mesh1))}
    check(blobs[4] == blobs[1], "IPP streams differ, 4 vs 1")
    print(f"four: GOP-parallel IPP {clip.shape} stream byte-identical "
          f"({len(blobs[4])} bytes)")

    # DWT level with the frame's rows sharded, halos over ppermute
    bank = dwt_ops.get_bank("db5")
    x = jnp.asarray(frames[0], jnp.float32)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh4, in_specs=(P("data"),),
                       out_specs=(P("data"), (P("data"),) * 3))
    def sharded(xl):
        return dwt_ops.analyze_level_rows_sharded(xl, bank, "data", 4)

    got = jax.tree.leaves(sharded(x))
    ref = jax.tree.leaves(jax.jit(lambda v: dwt_ops.analyze_level(v, bank))(x))
    err = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(got, ref))
    check(err <= 1e-4, f"halo-sharded DWT max error {err}")
    print(f"four: halo-sharded DWT level max abs error {err:.3e}")


PHASES = {"device": phase_device, "golden": phase_golden,
          "stills": phase_stills, "ipp": phase_ipp, "cli": phase_cli,
          "kernel": phase_kernel, "four": phase_four}


def phases(four: bool):
    """The phases one run executes, in order."""
    if four:
        return ["device", "four"]
    return ["device", "golden", "stills", "ipp", "cli", "kernel"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths, on a 4-card mesh")
    args = ap.parse_args(argv)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found ({jax.devices()})", file=sys.stderr)
        return 1
    with open(EXPECT) as f:
        ctx = {"expect": json.load(f)}
    for name in phases(args.four):
        t0 = time.perf_counter()
        try:
            PHASES[name](ctx)
        except Exception as e:  # report which phase, then fail the run
            print(f"phase {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            raise
        print(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
