"""End-to-end pipeline tests: encode -> decode round trips across stage
compositions, with RD sanity checks (the VCF notebook pattern, SURVEY §4)."""

import numpy as np
import pytest

from vcf_tpu import Codec, CodecConfig, CodeStream, metrics


def roundtrip(config, img):
    codec = Codec(config)
    cs = codec.encode(img)
    # serialize/deserialize to prove the container carries everything
    cs2 = CodeStream.from_bytes(cs.to_bytes())
    rec = Codec(config).decode(cs2)
    return cs, rec


class TestEntropyOnly:
    @pytest.mark.parametrize("entropy", ["png", "tiff", "pnm", "zlib"])
    def test_lossless(self, img_small, entropy):
        cfg = CodecConfig(spatial="none", color="none", quantizer="none", entropy=entropy)
        cs, rec = roundtrip(cfg, img_small)
        np.testing.assert_array_equal(rec, img_small)


class TestQuantizeOnly:
    def test_deadzone_bounds_error(self, img_small):
        cfg = CodecConfig(spatial="none", color="none", quantizer="deadzone",
                          entropy="zlib", qss=32)
        cs, rec = roundtrip(cfg, img_small)
        # reconstruction error bounded by the step size
        assert np.abs(rec.astype(int) - img_small.astype(int)).max() < 32

    def test_qss1_lossless(self, img_small):
        cfg = CodecConfig(spatial="none", color="none", quantizer="deadzone",
                          entropy="zlib", qss=1)
        cs, rec = roundtrip(cfg, img_small)
        np.testing.assert_array_equal(rec, img_small)


class TestColorPipeline:
    @pytest.mark.parametrize("color", ["ycocg", "ycrcb", "cdct"])
    def test_color_quantize(self, img_small, color):
        cfg = CodecConfig(spatial="none", color=color, quantizer="deadzone",
                          entropy="zlib", qss=16)
        cs, rec = roundtrip(cfg, img_small)
        assert metrics.rmse(img_small, rec) < 16

    def test_ycocg_r_qss1_lossless(self, img_small):
        cfg = CodecConfig(spatial="none", color="ycocg_r", quantizer="deadzone",
                          entropy="zlib", qss=1)
        cs, rec = roundtrip(cfg, img_small)
        np.testing.assert_array_equal(rec, img_small)


class TestDCTPipeline:
    def test_default_config_rd(self, img512):
        cfg = CodecConfig()  # VCF defaults: ycocg+dct8+subbands+deadzone32+tiff
        cs, rec = roundtrip(cfg, img512)
        report = metrics.j_cost(cs, img512, rec)
        assert report["distortion_rmse"] < 20.0
        assert report["rate_bpp"] < 4.0

    def test_small_qss_high_quality(self, img512):
        # qss=16 is the smallest step whose indexes cannot wrap the uint8
        # storage (|coeff| <= B*128 = 1024 -> |k| <= 64); the reference has
        # the same uint8 cast and the same wrap hazard (src/2D-DCT.py:361)
        cfg = CodecConfig(qss=16, entropy="zlib")
        cs, rec = roundtrip(cfg, img512)
        assert metrics.rmse(img512, rec) < 8.0

    def test_rd_monotonic_in_qss(self, img512):
        errs, rates = [], []
        for qss in (8, 32, 128):
            cfg = CodecConfig(qss=qss, entropy="zlib")
            cs, rec = roundtrip(cfg, img512)
            errs.append(metrics.rmse(img512, rec))
            rates.append(cs.total_bytes)
        assert errs[0] < errs[1] < errs[2]
        assert rates[0] > rates[1] > rates[2]

    def test_odd_shape_padding(self, img_odd):
        cfg = CodecConfig(qss=8, entropy="zlib")
        cs, rec = roundtrip(cfg, img_odd)
        assert rec.shape == img_odd.shape
        assert metrics.rmse(img_odd, rec) < 8.0

    def test_no_subbands(self, img_small):
        cfg = CodecConfig(subbands=False, qss=16, entropy="zlib")
        cs, rec = roundtrip(cfg, img_small)
        assert metrics.rmse(img_small, rec) < 12.0

    def test_perceptual(self, img512):
        cfg = CodecConfig(perceptual=True, qss=8, entropy="zlib")
        cs, rec = roundtrip(cfg, img512)
        assert metrics.rmse(img512, rec) < 20.0

    @pytest.mark.parametrize("block_size", [4, 16])
    def test_block_sizes(self, img_small, block_size):
        cfg = CodecConfig(block_size=block_size, qss=16, entropy="zlib")
        cs, rec = roundtrip(cfg, img_small)
        assert metrics.rmse(img_small, rec) < 12.0

    @pytest.mark.parametrize("entropy", ["huffman", "cbaac"])
    def test_entropy_backends(self, img_small, entropy):
        cfg = CodecConfig(qss=32, entropy=entropy)
        cs_z, rec_z = roundtrip(CodecConfig(qss=32, entropy="zlib"), img_small)
        cs, rec = roundtrip(cfg, img_small)
        # entropy stage must not change the reconstruction at all
        np.testing.assert_array_equal(rec, rec_z)


class TestLloydMax:
    def test_dct_lloydmax(self, img_small):
        cfg = CodecConfig(quantizer="lloydmax", qss=32, entropy="zlib")
        cs, rec = roundtrip(cfg, img_small)
        assert metrics.rmse(img_small, rec) < 25.0
        assert "q_levels" in cs  # side info rides in the stream


class TestVQ:
    def test_color_vq_palette(self, img_small):
        cfg = CodecConfig(spatial="none", color="none", quantizer="colorvq",
                          entropy="zlib", colorvq_clusters=32)
        cs, rec = roundtrip(cfg, img_small)
        # palette quantization: bounded error, few distinct colors
        uniq = np.unique(rec.reshape(-1, 3), axis=0)
        assert len(uniq) <= 32
        assert metrics.rmse(img_small, rec) < 40.0

    def test_spatial_vq(self, img_small):
        cfg = CodecConfig(spatial="none", color="ycocg", quantizer="vq",
                          entropy="zlib", vq_clusters=64, vq_block_size=4)
        cs, rec = roundtrip(cfg, img_small)
        assert "q_codebook" in cs
        assert metrics.rmse(img_small, rec) < 40.0

    def test_vq_deterministic(self, img_small):
        cfg = CodecConfig(spatial="none", color="none", quantizer="colorvq",
                          entropy="zlib", seed=5)
        cs1 = Codec(cfg).encode(img_small)
        cs2 = Codec(cfg).encode(img_small)
        assert cs1.to_bytes() == cs2.to_bytes()


class TestFilters:
    @pytest.mark.parametrize("filt", ["gaussian", "nlm", "bm3d"])
    def test_filter_runs(self, img_small, filt):
        cfg = CodecConfig(qss=64, entropy="zlib", filter=filt, filter_size=5)
        cs, rec = roundtrip(cfg, img_small)
        assert rec.shape == img_small.shape
        assert rec.dtype == np.uint8

    def test_bm3d_identity_and_denoise(self):
        """Real BM3D (hard-threshold stage): exact plumbing at
        threshold ~0 (every group member aggregates back losslessly)
        and a PSNR gain over both the noisy input and the r1-r3
        approximation on synthetic noise."""
        import jax.numpy as jnp
        from vcf_tpu.ops import filters
        from vcf_tpu.io import test_image

        rng = np.random.default_rng(1)
        x = rng.integers(0, 255, size=(32, 48, 3)).astype(np.float32)
        ident = np.asarray(filters.bm3d(jnp.asarray(x), 1e-9, s=2))
        assert np.abs(ident - x).max() < 1e-3

        clean = test_image(96, 112, seed=4).astype(np.float32)
        sigma = 15.0
        noisy = np.clip(clean + rng.normal(0, sigma, clean.shape), 0, 255)

        def psnr(a, b):
            mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
            return 10 * np.log10(255 ** 2 / mse)

        den = np.clip(np.asarray(filters.bm3d(jnp.asarray(noisy), sigma)),
                      0, 255)
        approx = np.clip(np.asarray(
            filters.bm3d_approx(jnp.asarray(noisy), sigma)), 0, 255)
        assert psnr(den, clean) > psnr(noisy, clean) + 3.0
        assert psnr(den, clean) > psnr(approx, clean)


class TestMetrics:
    def test_rmse_zero(self, img_small):
        assert metrics.rmse(img_small, img_small) == 0.0

    def test_bpp(self):
        cs = CodeStream()
        cs.payload = b"\x00" * 1000
        assert metrics.bpp(cs, (100, 100, 3)) == 1000 * 8 / (100 * 100)


class TestDeadzoneClamp:
    """The reference constructs Deadzone_Quantizer(Q_step, min_val=0,
    max_val=255) (src/deadzone.py:64): indexes that saturate the uint8
    support CLAMP, they do not wrap through the cast (SURVEY §7.3)."""

    def test_store_clamps_not_wraps(self):
        from vcf_tpu.codestream import CodeStream
        from vcf_tpu.pipeline import Codec

        codec = Codec(CodecConfig(entropy="zlib"))
        k = np.array([[-300, -129, -128, 0, 127, 128, 900]], np.int32)
        cs = CodeStream()
        codec._store_indexes(cs, k, {}, offset=128, dtype=np.uint8)
        stored = codec.entropy_codec.decode(
            cs.payload, {n: cs[n] for n in cs if n != "payload"})
        np.testing.assert_array_equal(
            stored.reshape(-1), [0, 0, 0, 128, 255, 255, 255])

    def test_qss1_saturating_image_roundtrip(self):
        # white image at qss=1: the DC index (~1016) saturates; with the
        # clamp the decoded image stays bright instead of wrapping dark
        img = np.full((16, 16, 3), 255, np.uint8)
        cfg = CodecConfig(qss=1, entropy="zlib")
        rec = Codec(cfg).decode(Codec(cfg).encode(img))
        assert rec.mean() > 130  # wrap semantics would give ~127 or worse
