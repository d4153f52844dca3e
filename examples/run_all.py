"""Executable examples — the equivalent of the reference's notebooks/.

The reference documents and tests itself through 26 notebooks, one per
codec, each doing: get the default image -> encode -> decode -> RDE
report (SURVEY §4).  This script runs the same sweeps as plain Python
(no network needed — the default inputs are the deterministic synthetic
image/video from vcf_tpu.io).

    python examples/run_all.py            # every codec, default knobs
    python examples/run_all.py dct dwt    # just those families
"""

import sys
import time

import numpy as np

from vcf_tpu import Codec, CodecConfig, metrics
from vcf_tpu.config import VideoConfig
from vcf_tpu.io import test_image
from vcf_tpu.io.video import test_video
from vcf_tpu import video

# (name, config, notes) — mirrors the reference notebook per-codec sweeps
STILL_SWEEPS = [
    # entropy-only round trips (PNG.ipynb, TIFF.ipynb, PNM.ipynb, z_lib.ipynb)
    ("png-lossless", CodecConfig(spatial="none", color="none", quantizer="none",
                                 entropy="png"), "lossless container"),
    ("tiff-lossless", CodecConfig(spatial="none", color="none", quantizer="none",
                                  entropy="tiff"), "lossless container"),
    ("pnm-raw", CodecConfig(spatial="none", color="none", quantizer="none",
                            entropy="pnm"), "rate upper bound"),
    # deadzone.ipynb
    ("deadzone-q32", CodecConfig(spatial="none", color="none",
                                 quantizer="deadzone", entropy="zlib"), ""),
    # YCoCg.ipynb / YCrCb.ipynb / color-DCT.ipynb
    ("ycocg-q16", CodecConfig(spatial="none", color="ycocg",
                              quantizer="deadzone", entropy="zlib", qss=16), ""),
    ("ycrcb-q16", CodecConfig(spatial="none", color="ycrcb",
                              quantizer="deadzone", entropy="zlib", qss=16), ""),
    ("cdct-q16", CodecConfig(spatial="none", color="cdct",
                             quantizer="deadzone", entropy="zlib", qss=16), ""),
    # 2D-DCT.ipynb sweeps: defaults, -x, -p -q 4 -B 32, LloydMax, YCrCb
    ("dct-default", CodecConfig(), "VCF defaults"),
    ("dct-nosubbands", CodecConfig(subbands=False), "-x"),
    ("dct-perceptual-B32", CodecConfig(perceptual=True, qss=4, block_size=32,
                                       entropy="zlib"), "-p -q 4 -B 32"),
    ("dct-lloydmax", CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib"),
     "-a LloydMax -m -2048 -n 2047"),
    ("dct-ycrcb", CodecConfig(color="ycrcb", entropy="zlib"), "-t YCrCb"),
    # 2D-DWT.ipynb
    ("dwt-db5-L5", CodecConfig(spatial="dwt", qss=16, entropy="zlib"), ""),
    ("dwt-bior22", CodecConfig(spatial="dwt", wavelet="bior2.2", qss=16,
                               dwt_levels=3, entropy="zlib"), ""),
    ("dwt-sym5", CodecConfig(spatial="dwt", wavelet="sym5", qss=16,
                             dwt_levels=3, entropy="zlib"),
     "near-linear-phase symlet"),
    ("dwt-bior44-97", CodecConfig(spatial="dwt", wavelet="bior4.4", qss=16,
                                  dwt_levels=3, entropy="zlib"),
     "CDF 9/7 (JPEG2000) pair"),
    ("dwt-coif2", CodecConfig(spatial="dwt", wavelet="coif2", qss=16,
                              dwt_levels=3, entropy="zlib"), ""),
    ("dct-grans", CodecConfig(entropy="grans"),
     "per-subband device rANS"),
    ("dct-cgrans", CodecConfig(entropy="cgrans"),
     "order-1 context device rANS (delegates to grans on small inputs)"),
    ("dct-cgrans15", CodecConfig(entropy="cgrans", context_classes=15),
     "15-class rate-priority context (r5)"),
    ("dwt-grans", CodecConfig(spatial="dwt", qss=16, dwt_levels=3,
                              entropy="grans"),
     "DWT with one-dispatch device entropy (r5)"),
    ("dwt-cgrans", CodecConfig(spatial="dwt", qss=16, dwt_levels=3,
                               entropy="cgrans"),
     "DWT device entropy + per-band order-1 context (r5)"),
    ("dct-cbaac-tiled", CodecConfig(entropy="cbaac", context_tiles=4),
     "per-tile parallel adaptive streams (--tiles)"),
    # 2D-KLT.ipynb / 2D-MDCT.ipynb / 2D-LBT.ipynb
    ("klt-q16", CodecConfig(spatial="klt", qss=16, entropy="zlib"), ""),
    ("mdct-q16", CodecConfig(spatial="mdct", qss=16, entropy="zlib"), ""),
    ("lbt-q32", CodecConfig(spatial="lbt", qss=32, lbt_epochs=100,
                            entropy="zlib"), ""),
    # VQ.ipynb / color-VQ.ipynb
    ("vq-256", CodecConfig(spatial="none", color="ycocg", quantizer="vq",
                           entropy="zlib", vq_clusters=256), ""),
    ("colorvq-32", CodecConfig(spatial="none", color="none",
                               quantizer="colorvq", entropy="zlib"), ""),
    # Huffman.ipynb / CBAHC.ipynb / CBAAC.ipynb entropy backends
    ("dct-huffman", CodecConfig(entropy="huffman"), ""),
    ("dct-ihuff", CodecConfig(entropy="ihuff"), "device interleaved"),
    ("dct-cbaac", CodecConfig(entropy="cbaac", context_order=1), ""),
    ("dct-cbahc", CodecConfig(entropy="cbahc", context_order=1,
                              qss=64), "slow by design (per-symbol rebuild)"),
    # gaussian_blur.ipynb / NLM.ipynb / BM3D.ipynb decode filters
    ("dct-gaussian", CodecConfig(qss=64, filter="gaussian", filter_size=5,
                                 entropy="zlib"), "-f gaussian_blur -s 5"),
    ("dct-nlm", CodecConfig(qss=64, filter="nlm", entropy="zlib"), ""),
    ("dct-bm3d", CodecConfig(qss=64, filter="bm3d", entropy="zlib"),
     "real two-stage BM3D (r4)"),
]

VIDEO_SWEEPS = [
    # III.ipynb: -T 2D-DWT sweep included
    ("iii-dct", VideoConfig(mode="iii", n_frames=8), CodecConfig(entropy="zlib")),
    ("iii-dwt", VideoConfig(mode="iii", n_frames=4),
     CodecConfig(spatial="dwt", qss=16, dwt_levels=3, entropy="zlib")),
    # IPP_DCT.ipynb: encode -N 20 -G 10 -M 16 -S 8 -q 64 -R 0.1
    ("ipp-default", VideoConfig(mode="ipp", n_frames=8, gop_size=4,
                                me_block=16, search_range=8),
     CodecConfig(qss=64, entropy="zlib")),
    ("ipp-rdo", VideoConfig(mode="ipp", n_frames=4, gop_size=4, me_block=16,
                            search_range=8, rdo_lambda=0.1),
     CodecConfig(qss=64, entropy="zlib")),
]


def main():
    only = set(sys.argv[1:])
    img = test_image(256, 256)
    print(f"{'example':<22} {'bpp':>7} {'rmse':>7} {'J':>8} {'enc_s':>6} {'dec_s':>6}")
    for name, cfg, note in STILL_SWEEPS:
        if only and not any(k in name for k in only):
            continue
        codec = Codec(cfg)
        t0 = time.time()
        cs = codec.encode(img)
        t1 = time.time()
        rec = Codec(cfg).decode(cs)
        t2 = time.time()
        rep = metrics.j_cost(cs, img, rec)
        print(f"{name:<22} {rep['rate_bpp']:7.3f} {rep['distortion_rmse']:7.2f} "
              f"{rep['J']:8.2f} {t1 - t0:6.1f} {t2 - t1:6.1f}  {note}")

    frames = test_video(8, 96, 112)
    for name, vcfg, ccfg in VIDEO_SWEEPS:
        if only and not any(k in name for k in only):
            continue
        codec = video.get(vcfg, ccfg)
        t0 = time.time()
        cs = codec.encode(frames[: vcfg.n_frames])
        t1 = time.time()
        rec = video.get(vcfg, ccfg).decode(cs)
        t2 = time.time()
        rep = metrics.video_report(cs, frames[: vcfg.n_frames], rec)
        print(f"{name:<22} {rep['rate_bpp']:7.3f} {rep['distortion_rmse']:7.2f} "
              f"{rep['J']:8.2f} {t1 - t0:6.1f} {t2 - t1:6.1f}")


if __name__ == "__main__":
    main()
