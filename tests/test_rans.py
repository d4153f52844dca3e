"""Interleaved rANS: butterfly routing, numpy/JAX equivalence, codec."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vcf_tpu.entropy import rans, get


def _skewed(shape, seed=0, sigma=4.0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, sigma, shape).round(), 0, 255).astype(np.uint8)


class TestButterfly:
    @pytest.mark.parametrize("seed", range(5))
    def test_compact_expand_random(self, seed):
        rng = np.random.default_rng(seed)
        s = int(rng.choice([8, 17, 64, 300]))
        flags = rng.random(s) < rng.random()
        vals = rng.integers(0, 10000, s).astype(np.int32)
        out = np.asarray(rans.butterfly_compact(jnp.asarray(vals), jnp.asarray(flags)))
        c = int(flags.sum())
        np.testing.assert_array_equal(out[:c], vals[flags])
        chunk = rng.integers(0, 10000, s).astype(np.uint32)
        out2 = np.asarray(rans.butterfly_expand(jnp.asarray(chunk), jnp.asarray(flags)))
        expect = np.zeros(s, np.uint32)
        expect[np.nonzero(flags)[0]] = chunk[:c]
        np.testing.assert_array_equal(out2, expect)

    def test_expand_exhaustive_small(self):
        """Every flag pattern at s=8 and s=11 (radix-4 routing covers a
        partial last digit at non-power-of-4 sizes).  One vmapped call
        per size: same coverage as per-pattern eager calls, seconds
        instead of half a minute (ADVICE r2)."""
        for s in (8, 11):
            vals = np.arange(1, s + 1, dtype=np.uint16)
            patterns = np.array(
                [[(bits >> i) & 1 for i in range(s)]
                 for bits in range(1 << s)], dtype=bool)
            out = np.asarray(jax.vmap(rans.butterfly_expand, in_axes=(None, 0))(
                jnp.asarray(vals), jnp.asarray(patterns)))
            for bits in range(1 << s):
                flags = patterns[bits]
                expect = np.zeros(s, np.uint16)
                expect[np.nonzero(flags)[0]] = vals[: int(flags.sum())]
                np.testing.assert_array_equal(out[bits], expect)

    @pytest.mark.parametrize("s", [64, 300, 1024])
    def test_compact4_matches_radix2(self, s):
        rng = np.random.default_rng(s)
        for _ in range(3):
            flags = rng.random(s) < rng.random()
            vals = rng.integers(0, 60000, s).astype(np.int32)
            a = np.asarray(rans._compact4(jnp.asarray(vals), jnp.asarray(flags)))
            b = np.asarray(
                rans.butterfly_compact(jnp.asarray(vals), jnp.asarray(flags)))
            c = int(flags.sum())
            np.testing.assert_array_equal(a[:c], b[:c])


class TestQuantizeFreqs:
    def test_sums_to_pow2(self):
        rng = np.random.default_rng(0)
        for _ in range(5):
            counts = rng.integers(0, 1000, 256)
            f = rans.quantize_freqs(counts)
            assert f.sum() == 1 << rans.K_PROB
            assert (f[counts > 0] >= 1).all()
            assert (f[counts == 0] == 0).all()

    def test_single_symbol(self):
        counts = np.zeros(256, np.int64)
        counts[7] = 100
        f = rans.quantize_freqs(counts)
        assert f[7] == 1 << rans.K_PROB


class TestNumpyReference:
    @pytest.mark.parametrize("s,l", [(1, 64), (8, 100), (32, 57)])
    def test_roundtrip(self, s, l):
        data = _skewed((s, l), seed=s)
        freqs = rans.quantize_freqs(np.bincount(data.reshape(-1), minlength=256))
        words, states = rans.np_encode(data, freqs)
        out = rans.np_decode(words, states, freqs, s, l)
        np.testing.assert_array_equal(out, data)


class TestJaxMatchesNumpy:
    @pytest.mark.parametrize("s,l", [(8, 64), (16, 123), (64, 50)])
    def test_encode_identical(self, s, l):
        data = _skewed((s, l), seed=l)
        freqs = rans.quantize_freqs(np.bincount(data.reshape(-1), minlength=256))
        cums = np.concatenate(([0], np.cumsum(freqs)))[:256].astype(np.uint32)
        w_ref, st_ref = rans.np_encode(data, freqs)
        words, n_words, states = rans.jax_encode(
            jnp.asarray(data), jnp.asarray(freqs.astype(np.uint32)),
            jnp.asarray(cums),
        )
        n_words = int(n_words)
        assert n_words == w_ref.size
        np.testing.assert_array_equal(np.asarray(words)[:n_words], w_ref)
        np.testing.assert_array_equal(np.asarray(states), st_ref)

    @pytest.mark.parametrize("s,l", [(8, 64), (32, 77)])
    def test_decode_identical(self, s, l):
        data = _skewed((s, l), seed=7 * l)
        freqs = rans.quantize_freqs(np.bincount(data.reshape(-1), minlength=256))
        cums = np.concatenate(([0], np.cumsum(freqs)))[:256].astype(np.uint32)
        words, states = rans.np_encode(data, freqs)
        wp = np.concatenate([words, np.zeros(s + 16, np.uint16)])
        out = rans.jax_decode(
            jnp.asarray(wp), jnp.int32(0), jnp.asarray(states),
            jnp.asarray(freqs.astype(np.uint32)), jnp.asarray(cums), l,
        )
        np.testing.assert_array_equal(np.asarray(out), data)


class TestRANSCodec:
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    def test_roundtrip(self, dtype):
        rng = np.random.default_rng(3)
        peak = 255 if dtype == np.uint8 else 4095
        arr = rng.integers(0, peak + 1, (45, 37, 3)).astype(dtype)
        codec = get("rans")
        payload, side = codec.encode(arr)
        rec = codec.decode(payload, side)
        np.testing.assert_array_equal(rec, arr)
        assert rec.dtype == arr.dtype

    def test_beats_huffman_on_skewed(self):
        data = _skewed((256, 256), seed=5, sigma=2.0)
        p_r, s_r = get("rans").encode(data)
        p_h, s_h = get("huffman").encode(data)
        total_r = len(p_r) + sum(len(v) for v in s_r.values())
        total_h = len(p_h) + sum(len(v) for v in s_h.values())
        # sub-bit-per-symbol coding: rANS beats Huffman's 1-bit floor
        assert total_r < total_h

    def test_pipeline_integration(self, img_small):
        from vcf_tpu import Codec, CodecConfig

        cfg = CodecConfig(entropy="rans", qss=32)
        cfg_z = CodecConfig(entropy="zlib", qss=32)
        rec = Codec(cfg).decode(Codec(cfg).encode(img_small))
        rec_z = Codec(cfg_z).decode(Codec(cfg_z).encode(img_small))
        np.testing.assert_array_equal(rec, rec_z)


class TestSparseRANS:
    def test_pack_unpack_flags(self):
        rng = np.random.default_rng(1)
        flags = rng.random(8 * 321) < 0.1
        packed = np.asarray(rans.pack_flags(jnp.asarray(flags)))
        np.testing.assert_array_equal(packed, np.packbits(flags))
        back = np.asarray(rans.unpack_flags(jnp.asarray(packed)))
        np.testing.assert_array_equal(back, flags)

    @pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
    @pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.97, 1.0])
    def test_roundtrip(self, dtype, sparsity):
        rng = np.random.default_rng(9)
        peak = 255 if dtype == np.uint8 else 4095
        arr = rng.integers(1, peak + 1, (93, 41, 3)).astype(dtype)
        arr[rng.random(arr.shape) < sparsity] = 128
        codec = get("srans")
        payload, side = codec.encode(arr)
        rec = codec.decode(payload, side)
        np.testing.assert_array_equal(rec, arr)
        assert rec.dtype == arr.dtype

    def test_beats_dense_rans_on_sparse(self):
        # clustered sparsity, like subband-ordered DCT planes: the gain
        # comes from flag bytes capturing 8-neighbor correlation
        rng = np.random.default_rng(4)
        arr = np.full((512, 512), 128, np.uint8)
        hits = np.zeros(arr.shape, bool)
        hits[:128, :128] = rng.random((128, 128)) < 0.6
        arr[hits] = rng.integers(120, 137, hits.sum()).astype(np.uint8)
        size = {}
        for name in ("rans", "srans"):
            p, s = get(name).encode(arr)
            size[name] = len(p) + sum(len(v) for v in s.values())
        assert size["srans"] < size["rans"]

    def test_pipeline_integration(self, img_small):
        from vcf_tpu import Codec, CodecConfig

        cfg = CodecConfig(entropy="srans", qss=32)
        cfg_z = CodecConfig(entropy="zlib", qss=32)
        rec = Codec(cfg).decode(Codec(cfg).encode(img_small))
        rec_z = Codec(cfg_z).decode(Codec(cfg_z).encode(img_small))
        np.testing.assert_array_equal(rec, rec_z)


class TestJitSparsePath:
    """jax_sparse_encode/decode: the fully-device sparse pipeline used by
    bench.py (flag bitplane + global compaction + two device rANS codes
    in one XLA program)."""

    @pytest.mark.parametrize("sparsity", [0.3, 0.9, 1.0])
    def test_roundtrip_device(self, sparsity):
        rng = np.random.default_rng(11)
        n, s_flags, s_nz = 1 << 14, 16, 32
        zero = np.uint8(128)
        flat = np.full(n, zero, np.uint8)
        hits = rng.random(n) >= sparsity
        flat[hits] = rng.integers(100, 160, hits.sum()).astype(np.uint8)
        true_nz = int((flat != zero).sum())  # draws of 128 are zeros too

        cap = max(s_nz, int(-(-max(true_nz, 1) // s_nz) * s_nz))
        flag_bytes = np.packbits(flat != zero)
        nz_host = flat[flat != zero]
        fill = np.uint8(np.argmax(np.bincount(nz_host, minlength=256))
                        if nz_host.size else 0)
        nz_padded = np.concatenate(
            [nz_host, np.full(cap - nz_host.size, fill, np.uint8)])

        def model(sym_arr):
            f = rans.quantize_freqs(np.bincount(sym_arr, minlength=256))
            c = np.concatenate(([0], np.cumsum(f)))[:256].astype(np.uint32)
            return jnp.asarray(f.astype(np.uint32)), jnp.asarray(c)

        ff, fc = model(flag_bytes)
        zf, zc = model(nz_padded)

        fw, fnw, fst, zw, znw, zst, n_nz = rans.jax_sparse_encode(
            jnp.asarray(flat), jnp.uint8(zero), jnp.uint8(fill),
            ff, fc, zf, zc, cap, s_flags, s_nz)
        assert int(n_nz) == true_nz and int(n_nz) <= cap

        def padw(words, nw, s):
            return jnp.concatenate(
                [words[: int(nw)], jnp.zeros((s + 16,), jnp.uint16)])

        out = rans.jax_sparse_decode(
            padw(fw, fnw, s_flags), fst, padw(zw, znw, s_nz), zst,
            jnp.uint8(zero), ff, fc, zf, zc,
            n, cap, (n // 8) // s_flags, cap // s_nz)
        np.testing.assert_array_equal(np.asarray(out), flat)

    def test_matches_host_streams(self):
        # the two embedded rANS codes must be bit-identical to np_encode
        # over the same (S, L) layout
        rng = np.random.default_rng(3)
        n, s_flags, s_nz = 1 << 12, 8, 8
        zero = np.uint8(128)
        flat = np.where(rng.random(n) < 0.8, zero,
                        rng.integers(0, 256, n)).astype(np.uint8)
        flags = flat != zero
        cap = int(-(-max(int(flags.sum()), 1) // s_nz) * s_nz)
        flag_bytes = np.packbits(flags)
        nz = flat[flags]
        fill = np.uint8(np.argmax(np.bincount(nz, minlength=256)))
        nz_padded = np.concatenate([nz, np.full(cap - nz.size, fill, np.uint8)])

        def model(a):
            f = rans.quantize_freqs(np.bincount(a, minlength=256))
            return f

        ff, zf = model(flag_bytes), model(nz_padded)
        fc = np.concatenate(([0], np.cumsum(ff)))[:256].astype(np.uint32)
        zc = np.concatenate(([0], np.cumsum(zf)))[:256].astype(np.uint32)

        fw, fnw, fst, zw, znw, zst, n_nz = rans.jax_sparse_encode(
            jnp.asarray(flat), jnp.uint8(zero), jnp.uint8(fill),
            jnp.asarray(ff.astype(np.uint32)), jnp.asarray(fc),
            jnp.asarray(zf.astype(np.uint32)), jnp.asarray(zc),
            cap, s_flags, s_nz)

        ref_fw, ref_fst = rans.np_encode(
            flag_bytes.reshape(-1, s_flags).T, ff)
        ref_zw, ref_zst = rans.np_encode(nz_padded.reshape(-1, s_nz).T, zf)
        np.testing.assert_array_equal(np.asarray(fw)[: int(fnw)], ref_fw)
        np.testing.assert_array_equal(np.asarray(fst), ref_fst)
        np.testing.assert_array_equal(np.asarray(zw)[: int(znw)], ref_zw)
        np.testing.assert_array_equal(np.asarray(zst), ref_zst)


class TestMinAllModel:
    def test_all_symbols_coverable(self):
        # a model trained on a SAMPLE must still code unseen symbols:
        # min_all gives every symbol freq >= 1 (sum still exactly 2^K)
        counts = np.zeros(256, np.int64)
        counts[10] = 1000  # sample saw only one symbol
        f = rans.quantize_freqs(counts, min_all=True)
        assert int(f.sum()) == 1 << rans.K_PROB
        assert (f >= 1).all()

        # stream containing symbols the sample never saw round-trips
        syms = np.full((4, 64), 10, np.uint8)
        syms[0, 3] = 255
        syms[2, 60] = 0
        words, states = rans.np_encode(syms.reshape(4, 64), f)
        out = rans.np_decode(words, states, f, 4, 64)
        np.testing.assert_array_equal(out, syms)


class TestGroupedRANS:
    """Per-lane-group tables (one model per DCT subband group)."""

    def _make(self, g, sg, l, seed=0):
        rng = np.random.default_rng(seed)
        # group g biased toward different symbols so tables differ
        syms = np.concatenate([
            rng.integers(0, 8 + 16 * i, size=(sg, l), dtype=np.int64)
            for i in range(g)]).astype(np.uint8)
        freqs_g = np.stack([
            rans.quantize_freqs(
                np.bincount(syms[i * sg:(i + 1) * sg].reshape(-1),
                            minlength=256), min_all=True)
            for i in range(g)])
        cums_g = np.stack([
            np.concatenate(([0], np.cumsum(f)))[:256].astype(np.uint32)
            for f in freqs_g])
        return syms, freqs_g.astype(np.uint32), cums_g

    @pytest.mark.parametrize("unroll", [1, 2, 4, 5])
    def test_jax_matches_np_reference(self, unroll):
        # unroll set covers the bench's preferred unroll=5 (ADVICE r2)
        syms, fg, cg = self._make(g=4, sg=8, l=40)
        w_np, st_np = rans.np_encode_grouped(syms, fg)
        w_j, nw, st_j = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg),
            unroll=unroll)
        nw = int(nw)
        np.testing.assert_array_equal(np.asarray(w_j[:nw]), w_np)
        np.testing.assert_array_equal(np.asarray(st_j), st_np)

    def test_roundtrip_jax(self):
        syms, fg, cg = self._make(g=8, sg=16, l=40, seed=3)
        w, nw, st = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
        nw = int(nw)
        wpad = jnp.concatenate(
            [w[:nw], jnp.zeros((syms.shape[0] + 16,), jnp.uint16)])
        out = rans.jax_decode_grouped(
            wpad, jnp.int32(0), st, jnp.asarray(fg), jnp.asarray(cg),
            syms.shape[1])
        np.testing.assert_array_equal(np.asarray(out), syms)

    def test_np_roundtrip(self):
        syms, fg, cg = self._make(g=2, sg=4, l=16, seed=5)
        w, st = rans.np_encode_grouped(syms, fg)
        out = rans.np_decode_grouped(w, st, fg, syms.shape[0], syms.shape[1])
        np.testing.assert_array_equal(out, syms)

    def test_g1_equals_global(self):
        syms, fg, cg = self._make(g=1, sg=32, l=20, seed=7)
        w1, nw1, st1 = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
        w0, nw0, st0 = rans.jax_encode(
            jnp.asarray(syms), jnp.asarray(fg[0]), jnp.asarray(cg[0]))
        assert int(nw1) == int(nw0)
        np.testing.assert_array_equal(
            np.asarray(w1[:int(nw1)]), np.asarray(w0[:int(nw0)]))
        np.testing.assert_array_equal(np.asarray(st1), np.asarray(st0))

    def test_rate_beats_global_on_mixed_stats(self):
        syms, fg, cg = self._make(g=4, sg=32, l=256, seed=9)
        fq_glob = rans.quantize_freqs(
            np.bincount(syms.reshape(-1), minlength=256), min_all=True)
        cg_glob = np.concatenate(([0], np.cumsum(fq_glob)))[:256].astype(np.uint32)
        _, nw_glob, _ = rans.jax_encode(
            jnp.asarray(syms), jnp.asarray(fq_glob.astype(np.uint32)),
            jnp.asarray(cg_glob))
        _, nw_grp, _ = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
        assert int(nw_grp) < int(nw_glob)


class TestSubbandLanes:
    def test_roundtrip_layout(self):
        rng = np.random.default_rng(11)
        planes = rng.integers(0, 256, size=(2, 32, 48, 3), dtype=np.uint8)
        s = 128  # G=64, sg=2; n=9216, L=72
        lanes = rans.subband_lanes(jnp.asarray(planes), 4, s)
        assert lanes.shape == (128, 9216 // 128)
        back = rans.subband_unlanes(lanes, 4, planes.shape)
        np.testing.assert_array_equal(np.asarray(back), planes)

    def test_grouped_pipeline_roundtrip(self):
        rng = np.random.default_rng(12)
        planes = (rng.integers(0, 6, size=(1, 64, 64, 3)) * 17 + 100
                  ).astype(np.uint8)
        b, s = 8, 256
        lanes = rans.subband_lanes(jnp.asarray(planes), b, s)
        fg, cg = rans.subband_group_freqs(np.asarray(planes), b)
        w, nw, st = rans.jax_encode_grouped(
            lanes, jnp.asarray(fg), jnp.asarray(cg))
        wpad = jnp.concatenate(
            [w[:int(nw)], jnp.zeros((s + 16,), jnp.uint16)])
        out = rans.jax_decode_grouped(
            wpad, jnp.int32(0), st, jnp.asarray(fg), jnp.asarray(cg),
            lanes.shape[1])
        rec = rans.subband_unlanes(out, b, planes.shape)
        np.testing.assert_array_equal(np.asarray(rec), planes)


class TestGroupedRANSCodec:
    def test_dct_plane_roundtrip_and_rate(self, ):
        from vcf_tpu import Codec, CodecConfig, CodeStream, metrics
        from vcf_tpu.io.images import test_image

        img = test_image(256, 256, seed=3)
        cfg_g = CodecConfig(entropy="grans")
        cfg_d = CodecConfig(entropy="rans")
        cs_g = Codec(cfg_g).encode(img)
        cs_d = Codec(cfg_d).encode(img)
        rec_g = Codec(cfg_g).decode(CodeStream.from_bytes(cs_g.to_bytes()))
        rec_d = Codec(cfg_d).decode(CodeStream.from_bytes(cs_d.to_bytes()))
        np.testing.assert_array_equal(rec_g, rec_d)  # entropy is lossless
        # per-subband models beat the global table on DCT planes
        assert metrics.bpp(cs_g, img.shape) < metrics.bpp(cs_d, img.shape)

    def test_fallback_on_ungroupable_shape(self):
        from vcf_tpu.entropy.rans import GroupedRANSCodec

        rng = np.random.default_rng(0)
        arr = rng.integers(0, 255, size=(30, 31, 3), dtype=np.uint8)  # not %8
        codec = GroupedRANSCodec()
        payload, side = codec.encode(arr)
        out = GroupedRANSCodec().decode(payload, side)
        np.testing.assert_array_equal(out, arr)

    def test_uint16_fallback(self):
        from vcf_tpu.entropy.rans import GroupedRANSCodec

        rng = np.random.default_rng(1)
        arr = rng.integers(0, 400, size=(32, 32, 3)).astype(np.uint16)
        codec = GroupedRANSCodec()
        payload, side = codec.encode(arr)
        out = GroupedRANSCodec().decode(payload, side)
        np.testing.assert_array_equal(out, arr)


class TestHierDecode:
    """Two-level symbol resolve must be bit-identical to the flat one."""

    def _enc(self, g, sg, l, seed):
        rng = np.random.default_rng(seed)
        syms = np.concatenate([
            rng.integers(0, 250, size=(sg, l), dtype=np.int64) // (i + 1)
            for i in range(g)]).astype(np.uint8)
        fg = np.stack([
            rans.quantize_freqs(np.bincount(
                syms[i * sg:(i + 1) * sg].reshape(-1), minlength=256),
                min_all=True) for i in range(g)]).astype(np.uint32)
        cg = np.stack([np.concatenate(([0], np.cumsum(f)))[:256]
                       for f in fg]).astype(np.uint32)
        w, nw, st = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
        wpad = jnp.concatenate(
            [w[:int(nw)], jnp.zeros((syms.shape[0] + 16,), jnp.uint16)])
        return syms, fg, cg, wpad, st

    @pytest.mark.parametrize("g,unroll", [(1, 1), (4, 1), (4, 2), (2, 4)])
    def test_matches_flat_decode(self, g, unroll):
        syms, fg, cg, wpad, st = self._enc(g, sg=16, l=32, seed=g)
        flat = rans.jax_decode_grouped(
            wpad, jnp.int32(0), st, jnp.asarray(fg), jnp.asarray(cg),
            syms.shape[1])
        hier = rans.jax_decode_hier(
            wpad, jnp.int32(0), st, jnp.asarray(fg), jnp.asarray(cg),
            syms.shape[1], unroll=unroll)
        np.testing.assert_array_equal(np.asarray(hier), np.asarray(flat))
        np.testing.assert_array_equal(np.asarray(hier), syms)

    def test_full_alphabet(self):
        # exercise every symbol incl. boundaries 0/255 and bucket edges
        syms = np.tile(np.arange(256, dtype=np.uint8), 8).reshape(16, 128)
        fg = rans.quantize_freqs(
            np.bincount(syms.reshape(-1), minlength=256), min_all=True
        )[None].astype(np.uint32)
        cg = np.concatenate(([0], np.cumsum(fg[0])))[:256][None].astype(np.uint32)
        w, nw, st = rans.jax_encode_grouped(
            jnp.asarray(syms), jnp.asarray(fg), jnp.asarray(cg))
        wpad = jnp.concatenate(
            [w[:int(nw)], jnp.zeros((syms.shape[0] + 16,), jnp.uint16)])
        out = rans.jax_decode_hier(
            wpad, jnp.int32(0), st, jnp.asarray(fg), jnp.asarray(cg),
            syms.shape[1], unroll=1)
        np.testing.assert_array_equal(np.asarray(out), syms)


class TestChunkedRouting:
    def test_expand_chunked_matches_global(self):
        rng = np.random.default_rng(0)
        n, chunk = 8 * 512, 512
        flags = jnp.asarray(rng.random(n) < 0.07)
        n_nz = int(jnp.sum(flags.astype(jnp.int32)))
        vals = jnp.asarray(
            np.concatenate([rng.integers(1, 255, n_nz),
                            np.zeros(n - n_nz)]).astype(np.uint32))
        glob = rans.butterfly_expand(vals, flags)
        chk = rans.butterfly_expand_chunked(vals[:n_nz + 3], flags, chunk)
        np.testing.assert_array_equal(np.asarray(chk), np.asarray(glob))

    def test_expand_chunked_tail_heavy(self):
        # all nonzeros in the last chunk: offsets reach past the prefix
        n, chunk = 4 * 256, 256
        flags = np.zeros(n, bool)
        flags[-200:] = True
        vals = jnp.asarray(np.arange(1, 201, dtype=np.uint32))
        out = np.asarray(rans.butterfly_expand_chunked(
            vals, jnp.asarray(flags), chunk))
        np.testing.assert_array_equal(out[-200:], np.arange(1, 201))
        assert (out[:-200] == 0).all()

    def test_compact_chunked_matches_global(self):
        rng = np.random.default_rng(1)
        n, chunk = 16 * 1024, 1024
        vals = jnp.asarray(rng.integers(0, 65535, n).astype(np.uint16))
        flags = jnp.asarray(rng.random(n) < 0.1)
        glob = rans.butterfly_compact(vals, flags)
        n_f = int(jnp.sum(flags.astype(jnp.int32)))
        chk, cnt = rans.butterfly_compact_chunked(vals, flags, chunk)
        assert int(cnt) == n_f
        np.testing.assert_array_equal(
            np.asarray(chk)[:n_f], np.asarray(glob)[:n_f])


def test_block_lanes_equals_subband_lanes_composed():
    from vcf_tpu.ops import dct as dct_ops

    rng = np.random.default_rng(3)
    planes = rng.integers(0, 256, size=(2, 32, 64, 3), dtype=np.uint8)
    s = 256  # G=64, sg=4
    import jax
    via_sb = rans.subband_lanes(
        jax.vmap(lambda p: dct_ops.to_subbands(p, 8))(jnp.asarray(planes)),
        8, s)
    direct = rans.block_lanes(jnp.asarray(planes), 8, s)
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(via_sb))
    back = rans.block_unlanes(direct, 8, planes.shape)
    np.testing.assert_array_equal(np.asarray(back), planes)


class TestCtxRANS:
    def test_np_mirror_pins_xla_encode(self):
        """jax_encode_ctx must match the per-symbol numpy reference
        (word order, states) exactly."""
        from vcf_tpu.entropy.rans import (
            np_encode_ctx, jax_encode_ctx, ctx_group_histograms,
            ctx_freqs_from_counts, subband_lanes)

        rng = np.random.default_rng(3)
        base = np.full((1, 32, 48, 3), 128, np.int32)
        noise = rng.integers(-6, 7, size=base.shape) * (
            rng.random(base.shape) < 0.3)
        planes = np.clip(base + noise, 0, 255).astype(np.uint8)
        s = 64 * 2
        lanes = np.asarray(subband_lanes(jnp.asarray(planes), 8, s))
        counts = np.asarray(ctx_group_histograms(jnp.asarray(lanes), 64))
        fgc, cgc = ctx_freqs_from_counts(counts)
        wn, xn = np_encode_ctx(lanes, fgc)
        wj, nj, xj, _ = jax_encode_ctx(jnp.asarray(lanes),
                                       jnp.asarray(fgc), jnp.asarray(cgc))
        np.testing.assert_array_equal(wn, np.asarray(wj)[:int(nj)])
        np.testing.assert_array_equal(xn, np.asarray(xj))

    def test_roundtrip_and_context_gain(self):
        """cgrans round-trips exactly and its STREAM (ex-sidecar) is
        smaller than order-0 grans on context-correlated planes."""
        from vcf_tpu.entropy.rans import CtxRANSCodec, GroupedRANSCodec

        rng = np.random.default_rng(4)
        # x-runs per channel -> strong left-neighbor correlation (the
        # ctx laning's lane-predecessor is the left-adjacent block)
        # lane-adjacent symbols sit 8 px apart (same in-block position
        # of adjacent blocks), so use runs much longer than one block
        runs = np.repeat(rng.integers(120, 137, size=(3, 512)), 64,
                         axis=1)[:, :24576]
        planes = runs.reshape(3, 128, 192).transpose(1, 2, 0)[None].astype(
            np.uint8)
        c = CtxRANSCodec()
        c.MIN_SYMBOLS = 0          # force the context path for the test
        p, s = c.encode(planes)
        np.testing.assert_array_equal(c.decode(p, s), planes)
        g = GroupedRANSCodec()
        pg, _ = g.encode(planes)
        assert len(p) < len(pg), (len(p), len(pg))

    def test_15_class_rate_priority(self):
        """The 15-class tables (r5 rate-priority mode) round-trip
        exactly and code at least as small a stream as the 4-class
        default on magnitude-correlated planes."""
        from vcf_tpu.entropy.rans import CtxRANSCodec

        rng = np.random.default_rng(6)
        runs = np.repeat(
            (128 + rng.normal(0, 20, size=(3, 512))).clip(0, 255), 64,
            axis=1)[:, :24576]
        planes = runs.reshape(3, 128, 192).transpose(1, 2, 0)[None].astype(
            np.uint8)
        c15 = CtxRANSCodec(n_ctx=15)
        c15.MIN_SYMBOLS = 0
        p15, s15 = c15.encode(planes)
        assert s15["cgrans_model"][0] == 2 and s15["cgrans_model"][1] == 15
        np.testing.assert_array_equal(c15.decode(p15, s15), planes)
        c4 = CtxRANSCodec(n_ctx=4)
        c4.MIN_SYMBOLS = 0
        p4, _ = c4.encode(planes)
        assert len(p15) <= len(p4), (len(p15), len(p4))

    def test_small_input_delegates(self):
        from vcf_tpu.entropy.rans import CtxRANSCodec

        rng = np.random.default_rng(5)
        planes = rng.integers(0, 255, size=(16, 24, 3)).astype(np.uint8)
        c = CtxRANSCodec()
        p, s = c.encode(planes)
        assert s["cgrans_model"][0] == 0       # delegated to order-0
        np.testing.assert_array_equal(c.decode(p, s), planes)


def test_cgrans_through_codec(img_small=None):
    """cgrans is a first-class entropy choice through the Codec/config
    surface (small inputs delegate to order-0 internally)."""
    from vcf_tpu import Codec, CodecConfig, CodeStream
    from vcf_tpu.io import test_image

    img = test_image(96, 112, seed=5)
    cfg = CodecConfig(entropy="cgrans")
    c = Codec(cfg)
    cs = c.encode(img)
    rec = Codec(cfg).decode(CodeStream.from_bytes(cs.to_bytes()))
    assert rec.shape == img.shape


class TestFormerKernelShapes:
    """Lane grids that tile into 128-lane groups with L*S % 32768 == 0
    (the shapes that once took platform-specific kernels) run the same
    path as every other shape: exact round trips, and the bytes of the
    NumPy reference."""

    @staticmethod
    def _planes(shape, seed):
        rng = np.random.default_rng(seed)
        mag = rng.geometric(0.45, shape) - 1
        return np.clip(128 + mag * rng.choice([-1, 1], shape), 0,
                       255).astype(np.uint8)

    def test_rans_codec(self):
        flat = self._planes((1024 * 512,), 1)
        codec = rans.RANSCodec()
        payload, side = codec.encode(flat)
        np.testing.assert_array_equal(codec.decode(payload, side), flat)
        syms = flat.reshape(512, 1024).T
        freqs = rans.quantize_freqs(np.bincount(flat, minlength=256))
        words, _ = rans.np_encode(syms, freqs)
        assert payload == words.astype("<u2").tobytes()

    def test_grans_codec(self):
        planes = self._planes((1, 256, 512, 32), 2)
        codec = rans.GroupedRANSCodec()
        payload, side = codec.encode(planes)
        np.testing.assert_array_equal(codec.decode(payload, side), planes)
        lanes = np.asarray(rans.subband_lanes(jnp.asarray(planes), 8, 8192))
        fg, _ = rans.freqs_from_counts(np.asarray(
            rans.group_histograms(jnp.asarray(lanes), 64)))
        words, _ = rans.np_encode_grouped(lanes, fg)
        assert payload == words.astype("<u2").tobytes()

    def test_cgrans_codec(self):
        planes = self._planes((1, 256, 512, 32), 3)
        codec = rans.CtxRANSCodec()
        payload, side = codec.encode(planes)
        assert side["cgrans_model"][0] == 2      # order-1, not delegated
        np.testing.assert_array_equal(codec.decode(payload, side), planes)
        lanes = np.asarray(
            rans.subband_lanes_ctx(jnp.asarray(planes), 8, 8192))
        fgc, _ = rans.ctx_freqs_from_counts(np.asarray(
            rans.ctx_group_histograms(jnp.asarray(lanes), 64)))
        words, _ = rans.np_encode_ctx(lanes, fgc)
        assert payload == words.astype("<u2").tobytes()

    def test_dwt_grid(self):
        from vcf_tpu.entropy import dwt_device as dd

        lanes = self._planes((3 * 128, 256), 4)
        fg, cg = dd.train_tables(jnp.asarray(lanes), 3)
        words, n, states, counts = dd.encode_grid(jnp.asarray(lanes), fg, cg)
        wn, sn = rans.np_encode_grouped(lanes, fg)
        np.testing.assert_array_equal(words, wn)
        np.testing.assert_array_equal(states, sn)
        back = dd.decode_grid(words, states, fg, cg, 256)
        np.testing.assert_array_equal(np.asarray(back), lanes)


def _walk_repair_reference(counts, k, min_all):
    """quantize_freqs as first written: the sum is repaired one visit at
    a time, walking the entries cyclically, largest first."""
    total = 1 << k
    counts = counts.astype(np.float64)
    if counts.sum() == 0:
        counts[:] = 1.0
    present = np.ones(counts.size, bool) if min_all else counts > 0
    f = np.zeros(counts.size, np.int64)
    f[present] = np.maximum(
        1, np.round(counts[present] / counts.sum() * total).astype(np.int64))
    diff = total - int(f.sum())
    order = np.argsort(-f, kind="stable")
    i = 0
    while diff != 0:
        s = order[i % counts.size]
        if f[s] > 1 or diff > 0:
            step = 1 if diff > 0 else -1
            f[s] += step
            diff -= step
        i += 1
    return f.astype(np.uint32)


@pytest.mark.parametrize("min_all", [False, True])
@pytest.mark.parametrize("kind", ["empty", "one_symbol", "few_symbols",
                                  "geometric", "uniform_small", "sparse_large",
                                  "alphabet_16", "alphabet_512"])
def test_quantize_freqs_matches_walk_repair(kind, min_all):
    rng = np.random.default_rng(len(kind) + 100 * min_all)
    for _ in range(20):
        if kind == "empty":
            c = np.zeros(256, np.int64)
        elif kind == "one_symbol":
            c = np.zeros(256, np.int64)
            c[rng.integers(256)] = rng.integers(1, 10 ** 7)
        elif kind == "few_symbols":
            c = np.zeros(256, np.int64)
            c[rng.integers(0, 256, 3)] = rng.integers(1, 10 ** 6, 3)
        elif kind == "geometric":
            c = np.bincount(np.clip(rng.geometric(
                rng.uniform(0.05, 0.99), 10 ** 5), 0, 255), minlength=256)
        elif kind == "uniform_small":
            c = rng.integers(0, 5, 256)
        elif kind == "sparse_large":
            c = rng.integers(0, 10 ** 6, 256) * (rng.random(256) < 0.1)
        else:
            c = rng.integers(0, 3, int(kind.split("_")[1]))
        for k in (12, 15):
            got = rans.quantize_freqs(c, k, min_all)
            np.testing.assert_array_equal(
                got, _walk_repair_reference(c, k, min_all))
            assert int(got.sum()) == 1 << k


def _np_encode_grouped_loop(syms, freqs_g):
    """The scalar-loop form of np_encode_grouped (one lane at a time,
    lanes descending within a step, words reversed at the end)."""
    s_streams, l = syms.shape
    sg = s_streams // freqs_g.shape[0]
    cums = np.concatenate([np.zeros((freqs_g.shape[0], 1), np.int64),
                           np.cumsum(freqs_g, axis=1)[:, :255]], axis=1)
    x = [rans.RANS_L] * s_streams
    emitted = []
    for t in range(l - 1, -1, -1):
        for s in range(s_streams - 1, -1, -1):
            v = int(syms[s, t])
            f, c = int(freqs_g[s // sg, v]), int(cums[s // sg, v])
            if x[s] >= f * ((rans.RANS_L << 16) >> rans.K_PROB):
                emitted.append(x[s] & 0xFFFF)
                x[s] >>= 16
            x[s] = ((x[s] // f) << rans.K_PROB) + x[s] % f + c
    return np.array(emitted[::-1], np.uint16), np.array(x, np.uint32)


def _np_encode_ctx_loop(syms, freqs_gc):
    s_streams, l = syms.shape
    g, n_ctx = freqs_gc.shape[:2]
    sg = s_streams // g
    cums = np.concatenate([np.zeros((g, n_ctx, 1), np.int64),
                           np.cumsum(freqs_gc, axis=2)[:, :, :255]], axis=2)
    x = [rans.RANS_L] * s_streams
    emitted = []
    for t in range(l - 1, -1, -1):
        for s in range(s_streams - 1, -1, -1):
            d = abs(int(syms[s, t - 1]) - 128) if t else 0
            c = sum(d >= b for b in rans.CTX_BOUNDS[n_ctx]) if t else 0
            v = int(syms[s, t])
            f = int(freqs_gc[s // sg, c, v])
            if (x[s] >> (32 - rans.K_PROB)) >= f:
                emitted.append(x[s] & 0xFFFF)
                x[s] >>= 16
            x[s] = ((x[s] // f) << rans.K_PROB) + x[s] % f \
                + int(cums[s // sg, c, v])
    return np.array(emitted[::-1], np.uint16), np.array(x, np.uint32)


def _np_decode_grouped_loop(words, states, freqs_g, s_streams, l):
    sg = s_streams // freqs_g.shape[0]
    cums = np.concatenate([np.zeros((freqs_g.shape[0], 1), np.int64),
                           np.cumsum(freqs_g, axis=1)[:, :255]], axis=1)
    x = [int(v) for v in states]
    out = np.zeros((s_streams, l), np.uint8)
    ptr = 0
    for t in range(l):
        for s in range(s_streams):
            grp = s // sg
            slot = x[s] & rans.MASK
            v = int(np.searchsorted(cums[grp], slot, side="right") - 1)
            while freqs_g[grp, v] == 0:          # zero-width symbols
                v -= 1
            out[s, t] = v
            x[s] = int(freqs_g[grp, v]) * (x[s] >> rans.K_PROB) + slot \
                - int(cums[grp, v])
            if x[s] < rans.RANS_L:
                x[s] = (x[s] << 16) | int(words[ptr])
                ptr += 1
    return out


@pytest.mark.parametrize("g,s_streams,l,p", [
    (1, 8, 33, 0.3), (2, 16, 20, 0.1), (4, 32, 9, 0.6), (8, 64, 5, 0.9)])
def test_vector_references_match_scalar_loops(g, s_streams, l, p):
    """The NumPy references run one vector step over all lanes; the
    scalar loops they replaced must give the same words and states."""
    rng = np.random.default_rng(g * 31 + l)
    syms = np.clip(128 + (rng.geometric(p, (s_streams, l)) - 1)
                   * rng.choice([-1, 1], (s_streams, l)), 0, 255
                   ).astype(np.uint8)
    fg, _ = rans.freqs_from_counts(np.stack(
        [np.bincount(syms[i * s_streams // g:(i + 1) * s_streams // g]
                     .ravel(), minlength=256) for i in range(g)]))
    words, states = rans.np_encode_grouped(syms, fg)
    w0, s0 = _np_encode_grouped_loop(syms, fg.astype(np.int64))
    np.testing.assert_array_equal(words, w0)
    np.testing.assert_array_equal(states, s0)
    np.testing.assert_array_equal(
        rans.np_decode_grouped(words, states, fg, s_streams, l),
        _np_decode_grouped_loop(words, states, fg.astype(np.int64),
                                s_streams, l))
    fgc, _ = rans.ctx_freqs_from_counts(np.asarray(
        rans.ctx_group_histograms(jnp.asarray(syms), g)))
    wc, sc = rans.np_encode_ctx(syms, fgc)
    wc0, sc0 = _np_encode_ctx_loop(syms, fgc.astype(np.int64))
    np.testing.assert_array_equal(wc, wc0)
    np.testing.assert_array_equal(sc, sc0)
