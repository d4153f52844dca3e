"""DWT: filter construction, perfect reconstruction, pipeline flow."""

import numpy as np
import jax.numpy as jnp
import pytest

from vcf_tpu import Codec, CodecConfig, CodeStream, metrics
from vcf_tpu.ops import dwt


class TestFilters:
    @pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
    def test_daubechies_orthonormal(self, p):
        h = dwt.daubechies_lowpass(p)
        assert len(h) == 2 * p
        assert abs(h.sum() - np.sqrt(2)) < 1e-10
        assert abs(np.dot(h, h) - 1.0) < 1e-10
        for k in range(1, p):
            assert abs(np.dot(h[2 * k :], h[: -2 * k])) < 1e-8

    @pytest.mark.parametrize("p", [2, 5])
    def test_vanishing_moments(self, p):
        h = dwt.daubechies_lowpass(p)
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        for m in range(p):
            assert abs(np.sum(g * np.arange(len(g)) ** m)) < 1e-6

    @pytest.mark.parametrize("p", [2, 4, 5, 8, 10])
    def test_symlet_orthonormal_with_moments(self, p):
        h = dwt.symlet_lowpass(p)
        assert len(h) == 2 * p
        assert abs(h.sum() - np.sqrt(2)) < 1e-8
        assert abs(np.dot(h, h) - 1.0) < 1e-8
        for k in range(1, p):
            assert abs(np.dot(h[2 * k:], h[: -2 * k])) < 1e-7
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        for m in range(min(p, 6)):
            assert abs(np.sum(g * np.arange(len(g)) ** m)) < 1e-4

    def test_sym4_published_coefficients(self):
        # pywt sym4 dec_lo (reversed-order convention), published table
        ref = np.array([
            0.03222310060404270, -0.012603967262037833,
            -0.09921954357684722, 0.29785779560527736,
            0.8037387518059161, 0.49761866763201545,
            -0.02963552764599851, -0.07576571478927333,
        ])[::-1]
        np.testing.assert_allclose(dwt.symlet_lowpass(4), ref, atol=1e-10)

    @pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
    def test_coiflet_defining_properties(self, n):
        h = dwt.coiflet_lowpass(n)
        assert len(h) == 6 * n
        assert abs(h.sum() - np.sqrt(2)) < 1e-8
        for k in range(1, 3 * n):
            assert abs(np.dot(h[2 * k:], h[: -2 * k])) < 1e-7
        idx = np.arange(-2 * n, 4 * n).astype(float)
        sgn = (-1.0) ** np.arange(6 * n)
        for j in range(2 * n):       # wavelet vanishing moments
            assert abs(np.sum(sgn * idx ** j * h)) < 1e-5
        for j in range(1, 2 * n):    # scaling-function vanishing moments
            assert abs(np.sum(idx ** j * h)) < 1e-5

    def test_coif2_published_coefficients(self):
        # pywt coif2 dec_lo (reversed-order convention)
        ref = np.array([
            -0.0007205494453645122, -0.0018232088707029932,
            0.0056114348193944995, 0.023680171946334084,
            -0.0594344186464569, -0.0764885990783064,
            0.41700518442169254, 0.8127236354455423,
            0.3861100668211622, -0.06737255472196302,
            -0.04146493678175915, 0.016387336463522112,
        ])[::-1]
        np.testing.assert_allclose(dwt.coiflet_lowpass(2), ref, atol=1e-9)

    def test_cdf97_is_pywt_bior44(self):
        # JPEG2000 irrational 9/7 pair (== pywt bior4.4 up to the zero pad)
        dec_lo, _, rec_lo, _ = dwt.cdf97_filters()
        np.testing.assert_allclose(
            dec_lo,
            [0.037828455506995, -0.023849465019380, -0.110624404418423,
             0.377402855612650, 0.852698679009403, 0.377402855612650,
             -0.110624404418423, -0.023849465019380, 0.037828455506995],
            atol=1e-9,
        )
        np.testing.assert_allclose(
            rec_lo,
            [-0.064538882628938, -0.040689417609559, 0.418092273222212,
             0.788485616405665, 0.418092273222212, -0.040689417609559,
             -0.064538882628938],
            atol=1e-9,
        )


class TestPerfectReconstruction:
    @pytest.mark.parametrize("wavelet", ["haar", "db2", "db5", "bior2.2"])
    def test_one_level(self, wavelet):
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(size=(64, 48, 3)).astype(np.float32))
        bank = dwt.get_bank(wavelet)
        ll, d = dwt.analyze_level(x, bank)
        assert ll.shape == (32, 24, 3)
        y = dwt.synthesize_level(ll, d, bank, (64, 48))
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-4)

    @pytest.mark.parametrize("levels", [1, 3, 5])
    def test_multilevel(self, levels):
        rng = np.random.default_rng(1)
        n = 32 << levels if levels < 4 else 32 * 32
        x = jnp.asarray(rng.normal(size=(64, 64, 3)).astype(np.float32))
        decomp = dwt.analyze(x, "db5", levels)
        assert decomp[0].shape == (64 >> levels, 64 >> levels, 3)
        y = dwt.synthesize(decomp, "db5")
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-3)

    @pytest.mark.parametrize("wavelet", [
        "sym5", "sym8", "coif1", "coif3", "coif5",
        "bior1.3", "bior2.4", "bior3.5", "bior4.4", "bior6.8",
        "rbio2.2", "rbio4.4", "cdf97",
    ])
    def test_new_families_pr(self, wavelet):
        """VERDICT r3 missing #1: the reference's -w accepts any pywt
        name (src/2D-DWT.py:22-32); every supported family must
        perfectly reconstruct."""
        rng = np.random.default_rng(7)
        x = jnp.asarray(rng.normal(size=(64, 48, 3)).astype(np.float32))
        decomp = dwt.analyze(x, wavelet, 2)
        y = dwt.synthesize(decomp, wavelet)
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=2e-3)

    def test_unknown_wavelet_rejected(self):
        with pytest.raises(ValueError):
            dwt.get_bank("bior2.3")  # parity mismatch: not a valid pair
        with pytest.raises(ValueError):
            dwt.get_bank("nosuchwavelet")

    def test_energy_compaction(self):
        # smooth image -> detail subbands near zero for db5
        y, x = np.mgrid[0:64, 0:64] / 64.0
        img = jnp.asarray(
            np.stack([np.sin(2 * np.pi * x), np.cos(2 * np.pi * y), x * y], -1)
            .astype(np.float32)
        )
        decomp = dwt.analyze(img, "db5", 2)
        ll_energy = float(jnp.sum(decomp[0] ** 2))
        detail_energy = sum(
            float(jnp.sum(b**2)) for d in decomp[1:] for b in d
        )
        assert ll_energy > 50 * detail_energy


class TestDWTPipeline:
    def test_roundtrip_rd(self, img512):
        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=3, entropy="zlib")
        codec = Codec(cfg)
        cs = codec.encode(img512)
        cs2 = CodeStream.from_bytes(cs.to_bytes())
        rec = Codec(cfg).decode(cs2)
        assert rec.shape == img512.shape
        assert metrics.rmse(img512, rec) < 10.0

    def test_subband_streams_present(self, img_small):
        cfg = CodecConfig(spatial="dwt", qss=32, dwt_levels=2, entropy="zlib")
        cs = Codec(cfg).encode(img_small)
        assert "LL_2" in cs
        for name in ("LH_2", "HL_2", "HH_2", "LH_1", "HL_1", "HH_1"):
            assert name in cs

    @pytest.mark.parametrize("wavelet", ["sym5", "bior4.4", "coif2"])
    def test_roundtrip_new_families(self, img_small, wavelet):
        """VERDICT r3 next #6 done-criterion: -w sym5 / -w bior4.4
        round-trip through the full pipeline."""
        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=2,
                          wavelet=wavelet, entropy="zlib")
        codec = Codec(cfg)
        rec = Codec(cfg).decode(codec.encode(img_small))
        assert rec.shape == img_small.shape
        assert metrics.rmse(img_small, rec) < 12.0

    def test_odd_shape(self, img_odd):
        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=2, entropy="zlib")
        codec = Codec(cfg)
        rec = Codec(cfg).decode(codec.encode(img_odd))
        assert rec.shape == img_odd.shape
        assert metrics.rmse(img_odd, rec) < 12.0

    def test_lloydmax_quantizer(self, img_small):
        cfg = CodecConfig(spatial="dwt", quantizer="lloydmax", qss=64,
                          dwt_levels=2, entropy="zlib")
        codec = Codec(cfg)
        rec = Codec(cfg).decode(codec.encode(img_small))
        assert metrics.rmse(img_small, rec) < 30.0


class TestLBTPipeline:
    def test_roundtrip_rd(self, img_small):
        cfg = CodecConfig(spatial="lbt", qss=16, lbt_epochs=60, entropy="zlib")
        codec = Codec(cfg)
        cs = codec.encode(img_small)
        assert "weights" in cs and "mean" in cs
        rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
        assert metrics.rmse(img_small, rec) < 12.0

    def test_beats_identity_on_coding_gain(self, img_small):
        # trained transform should concentrate energy at least as well as
        # its DCT init: reconstruction at same qss not much worse than dct
        cfg_lbt = CodecConfig(spatial="lbt", qss=32, lbt_epochs=60, entropy="zlib")
        cfg_dct = CodecConfig(spatial="dct", qss=32, entropy="zlib")
        rec_lbt = Codec(cfg_lbt).decode(Codec(cfg_lbt).encode(img_small))
        rec_dct = Codec(cfg_dct).decode(Codec(cfg_dct).encode(img_small))
        e_lbt = metrics.rmse(img_small, rec_lbt)
        e_dct = metrics.rmse(img_small, rec_dct)
        assert e_lbt < e_dct * 1.5


class TestDWTDeviceEntropy:
    """r5 (VERDICT r4 missing #1): one-dispatch grouped-rANS entropy
    for the DWT pipeline — per-band groups, device scan both ways."""

    def test_roundtrip_matches_host_path(self, img512):
        from vcf_tpu import Codec, CodecConfig, CodeStream, metrics

        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=3,
                          entropy="grans")
        cs = Codec(cfg).encode(img512)
        rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
        # reconstruction matches the host entropy backends within the
        # documented +-1 quantization knife edge (the device path fuses
        # analyze+quantize in one jit; float contraction order differs
        # from the host path's separate dispatches — CLAUDE.md law)
        cfgz = cfg.replace(entropy="zlib")
        recz = Codec(cfgz).decode(
            CodeStream.from_bytes(Codec(cfgz).encode(img512).to_bytes()))
        diff = np.abs(rec.astype(np.int32) - recz.astype(np.int32))
        assert diff.max() <= 1 and (diff != 0).mean() < 1e-4
        assert "gdwt_words" in cs and "gdwt_model" in cs

    def test_odd_shape_device(self):
        from vcf_tpu import Codec, CodecConfig, CodeStream, metrics
        from vcf_tpu.io import test_image as make_img

        img = make_img(130, 94, seed=5)
        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=2,
                          entropy="grans")
        cs = Codec(cfg).encode(img)
        rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
        assert rec.shape == img.shape
        assert metrics.rmse(img, rec) < 10.0

    def test_grid_pack_unpack_exact(self):
        from vcf_tpu.entropy import dwt_device as dd

        rng = np.random.default_rng(0)
        sizes = [700, 3000, 12000]
        bands = [jnp.asarray(rng.integers(0, 256, (n,), np.uint8))
                 for n in sizes]
        sg, l = dd.grid_dims(sizes)
        lanes = dd.bands_to_grid(bands, sg, l)
        assert lanes.shape == (len(sizes) * sg, l)
        back = dd.grid_to_bands(lanes, sizes, sg)
        for a, b in zip(bands, back):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_ctx_mode_roundtrip(self):
        """cgrans DWT (r5): order-1 per-band tables beat order-0 grans
        on run-structured bands; small inputs stay order-0 (v1)."""
        from vcf_tpu import Codec, CodecConfig, CodeStream
        from vcf_tpu.entropy import dwt_device as dd
        from vcf_tpu.io import test_image as make_img

        img = make_img(512, 512, seed=2)
        cfg = CodecConfig(spatial="dwt", qss=16, dwt_levels=3,
                          entropy="cgrans")
        # force the ctx path on this 786k-symbol input
        import vcf_tpu.ops.dwt as dwt_mod
        old_min = dwt_mod.CTX_MIN_SYMBOLS
        dwt_mod.CTX_MIN_SYMBOLS = 0
        try:
            cs = Codec(cfg).encode(img)
        finally:
            dwt_mod.CTX_MIN_SYMBOLS = old_min
        ver = cs["gdwt_model"][0]
        assert ver == 2   # ctx engaged (threshold forced to 0 above)
        rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
        cfg0 = cfg.replace(entropy="grans")
        cs0 = Codec(cfg0).encode(img)
        rec0 = Codec(cfg0).decode(CodeStream.from_bytes(cs0.to_bytes()))
        np.testing.assert_array_equal(rec, rec0)   # entropy is lossless
        assert cs.total_bytes < cs0.total_bytes, (
            cs.total_bytes, cs0.total_bytes)

    def test_model_sidecar_roundtrip(self):
        from vcf_tpu.entropy import dwt_device as dd

        rng = np.random.default_rng(1)
        g, sg, l = 5, 16, 64
        states = rng.integers(1 << 16, 1 << 31, (g * sg,)).astype(np.uint32)
        counts = rng.integers(0, 40, (l,)).astype(np.int64)
        fg = np.full((g, 256), 128, np.uint32)
        blob = dd.pack_model(g, sg, l, 1234, 16, states, counts, fg)
        g2, sg2, l2, nw, qss, st2, c2, fg2, cg2, nctx = dd.unpack_model(blob)
        assert (g2, sg2, l2, nw, qss, nctx) == (g, sg, l, 1234, 16, 0)
        np.testing.assert_array_equal(st2, states)
        np.testing.assert_array_equal(c2, counts)
        np.testing.assert_array_equal(fg2, fg)


@pytest.mark.parametrize("wavelet", ["haar", "db5", "bior4.4"])
def test_halo_sharded_analyze_level(wavelet):
    """Row-sharded DWT analysis with halo exchange equals the unsharded
    transform (SURVEY §5; VERDICT r4 missing #3).  bior4.4 exercises
    negative shifts (halo on both sides)."""
    import functools
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from vcf_tpu.ops import dwt

    n_t = 4
    devs = jax.devices()[:n_t]
    mesh = Mesh(np.array(devs), ("tile",))
    bank = dwt.get_bank(wavelet)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(128, 32, 3)).astype(np.float32))

    @jax.jit
    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P("tile"),),
        out_specs=(P("tile"), (P("tile"), P("tile"), P("tile"))))
    def sharded(xl):
        return dwt.analyze_level_rows_sharded(xl, bank, "tile", n_t)

    ll_s, (lh_s, hl_s, hh_s) = sharded(x)
    ll, (lh, hl, hh) = dwt.analyze_level(x, bank)
    for a, b_ in ((ll, ll_s), (lh, lh_s), (hl, hl_s), (hh, hh_s)):
        np.testing.assert_allclose(np.asarray(b_), np.asarray(a),
                                   rtol=0, atol=1e-5)


def test_lbt_side_info_external_file(img_small, tmp_path):
    """--side_info stores the trained weights outside the stream
    (2D-LBT.py:39,48,391-398,530-537)."""
    from vcf_tpu import Codec, CodecConfig, CodeStream, metrics

    path = str(tmp_path / "w.npz")
    cfg = CodecConfig(spatial="lbt", qss=16, lbt_epochs=40, entropy="zlib",
                      lbt_side_info=path)
    cs = Codec(cfg).encode(img_small)
    assert "weights" not in cs and "mean" not in cs
    import os
    assert os.path.exists(path)
    rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
    assert metrics.rmse(img_small, rec) < 10.0
