"""2D dyadic discrete wavelet transform (device-side).

Capability parity with the reference's 2D-DWT stage
(src/2D-DWT.py, backed by `DWT2D.color_dyadic_DWT` / PyWavelets):
multilevel per-channel dyadic decomposition with `-l` levels and `-w`
wavelet (default db5), per-subband quantization, and **each subband
written as its own codestream** — LL stored as uint16 (+128), detail
subbands as uint8 (+128) (src/2D-DWT.py:162-200).

Device implementation.  PyWavelets is not available in this
environment, so the filter banks are constructed from scratch:

* `haar`, `dbN` (Daubechies, N=1..10) — orthonormal lowpass by
  spectral factorization of the Daubechies polynomial (minimum phase);
  validated by orthonormality and vanishing-moment tests
  (tests/test_dwt.py).
* `symN` (Symlets, N=2..10) — same half-band polynomial, spectral
  factors chosen per conjugate-pair group to minimize phase
  nonlinearity (near-linear phase); sym4 reproduces the published
  coefficients exactly (reflection convention may differ from pywt,
  which leaves the transform equivalent).
* `coifN` (Coiflets, N=1..5) — coif1 in closed form
  ((1-√7, 5+√7, 14+2√7, 14-2√7, 1-√7, -3+√7)·√2/32); higher orders by
  Newton/least-squares on the defining system (orthonormality + 2N
  wavelet moments + 2N-1 scaling moments) with continuation from
  coif(N-1); coif2 reproduces the published coefficients to 1e-15.
* `biorN.M` / `rbioN.M` (CDF spline biorthogonal family, the pywt
  grid: 1.1/1.3/1.5, 2.2/2.4/2.6/2.8, 3.1..3.9, 4.4, 5.5, 6.8) —
  closed-form spline construction (rec_lo = B-spline(N), dec_lo =
  complementary factor with M vanishing moments via the Bezout
  polynomial); `bior4.4` is the CDF 9/7 (JPEG2000 irrational) pair by
  splitting the q=4 Bezout polynomial's real root to synthesis and the
  complex pair to analysis, matching pywt.  Periodization phases are
  auto-calibrated at bank build time by an exhaustive PR search and
  verified to 1e-8 (`_calibrate`).
* `bior2.2` / `legall53` keep the original hand-derived CDF 5/3 bank
  (sign convention pinned by existing tests).

Boundary handling is periodization: subband sizes halve exactly at
every level and all shapes stay static under jit.  Analysis is
`sum_j h[j] * roll(x, -(j+shift))` downsampled by 2; synthesis is the
circular convolution of the zero-upsampled bands with the synthesis
filters at the phase that gives perfect reconstruction (for orthonormal
banks this is exactly the adjoint of the analysis operator).  Rolls and
adds are pure VPU/HBM work that XLA fuses per level.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from vcf_tpu.codestream import CodeStream, PAYLOAD
from vcf_tpu.ops import color as color_ops
from vcf_tpu.ops import dct as dct_ops


# ---------------------------------------------------------------------------
# Filter construction
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def daubechies_lowpass(p: int) -> np.ndarray:
    """Orthonormal Daubechies lowpass filter of order p (length 2p).

    Spectral factorization: roots of the Daubechies half-band
    polynomial P(y) = sum_{k<p} C(p-1+k, k) y^k are mapped to z-roots
    of z + 1/z = 2 - 4y keeping |z| < 1 (minimum phase), then
    h(z) ~ (1+z)^p * prod(z - z_k), normalized to sum = sqrt(2).
    """
    if p == 1:
        return np.array([1.0, 1.0]) / math.sqrt(2.0)
    coeffs = [math.comb(p - 1 + k, k) for k in range(p)]
    yroots = np.roots(coeffs[::-1])
    zroots = []
    for y in yroots:
        bq = 2.0 - 4.0 * y
        disc = np.sqrt(bq * bq - 4.0 + 0j)
        z1, z2 = (bq + disc) / 2.0, (bq - disc) / 2.0
        zroots.append(z1 if abs(z1) < 1.0 else z2)
    poly = np.array([1.0 + 0j])
    for _ in range(p):
        poly = np.convolve(poly, [1.0, 1.0])
    for zk in zroots:
        poly = np.convolve(poly, [1.0, -zk])
    h = np.real(poly)
    h *= math.sqrt(2.0) / h.sum()
    return h


class Bank:
    """Analysis/synthesis filters + periodization phases (see
    tests/test_dwt.py for the perfect-reconstruction check)."""

    def __init__(self, dec_lo, dec_hi, rec_lo, rec_hi,
                 shift_lo=0, shift_hi=0, phase_lo=0, phase_hi=0):
        self.dec_lo = np.asarray(dec_lo, np.float32)
        self.dec_hi = np.asarray(dec_hi, np.float32)
        self.rec_lo = np.asarray(rec_lo, np.float32)
        self.rec_hi = np.asarray(rec_hi, np.float32)
        self.shift_lo, self.shift_hi = shift_lo, shift_hi
        self.phase_lo, self.phase_hi = phase_lo, phase_hi


@functools.lru_cache(maxsize=None)
def symlet_lowpass(p: int) -> np.ndarray:
    """Near-linear-phase orthonormal lowpass (Symlet) of order p.

    Same Daubechies half-band polynomial as `daubechies_lowpass`, but
    the spectral factor is chosen per conjugate-root-pair group (root
    inside vs outside the unit circle) to minimize the filter's
    deviation from linear phase — the Symlet selection rule.
    """
    if p < 2:
        return daubechies_lowpass(max(p, 1))
    import itertools

    coeffs = [math.comb(p - 1 + k, k) for k in range(p)]
    yroots = np.roots(coeffs[::-1])
    zin = []
    for y in yroots:
        bq = 2.0 - 4.0 * y
        disc = np.sqrt(bq * bq - 4.0 + 0j)
        z1, z2 = (bq + disc) / 2.0, (bq - disc) / 2.0
        zin.append(z1 if abs(z1) < 1.0 else z2)
    # group real roots singly, complex conjugate pairs jointly (a real
    # filter needs both members flipped together)
    groups, used = [], [False] * len(zin)
    for i, z in enumerate(zin):
        if used[i]:
            continue
        if abs(z.imag) < 1e-9:
            groups.append([i])
            used[i] = True
        else:
            for j in range(i + 1, len(zin)):
                if not used[j] and abs(zin[j] - np.conj(z)) < 1e-7:
                    groups.append([i, j])
                    used[i] = used[j] = True
                    break
            else:  # pragma: no cover - defensive
                groups.append([i])
                used[i] = True

    def build(zsel):
        poly = np.array([1.0 + 0j])
        for _ in range(p):
            poly = np.convolve(poly, [1.0, 1.0])
        for zk in zsel:
            poly = np.convolve(poly, [1.0, -zk])
        h = np.real(poly)
        h *= math.sqrt(2.0) / h.sum()
        return h

    w = np.linspace(0.01, np.pi * 0.8, 256)
    ns = np.arange(2 * p)

    def phase_dev(h):
        resp = np.exp(-1j * np.outer(w, ns)) @ h
        ph = np.unwrap(np.angle(resp))
        a = np.vstack([w, np.ones_like(w)]).T
        sol, *_ = np.linalg.lstsq(a, ph, rcond=None)
        return float(np.sum((ph - a @ sol) ** 2))

    best = None
    for sel in itertools.product([0, 1], repeat=len(groups)):
        zs = []
        for grp, s in zip(groups, sel):
            for i in grp:
                z = zin[i]
                zs.append(z if s == 0 else 1.0 / np.conj(z))
        h = build(zs)
        d = phase_dev(h)
        if best is None or d < best[0]:
            best = (d, h)
    return best[1]


@functools.lru_cache(maxsize=None)
def coiflet_lowpass(n: int) -> np.ndarray:
    """Coiflet-n lowpass, length 6n, support indices [-2n, 4n-1].

    coif1 is the closed form √2/32·(1-√7, 5+√7, 14+2√7, 14-2√7, 1-√7,
    -3+√7); higher orders solve the defining system (orthonormality,
    2n vanishing wavelet moments, 2n-1 vanishing scaling-function
    moments, Σh=√2) by damped least-squares continuation from
    coif(n-1).  coif2 matches the published table to ~1e-15.
    """
    s7 = math.sqrt(7.0)
    h = np.array([1 - s7, 5 + s7, 14 + 2 * s7, 14 - 2 * s7, 1 - s7, -3 + s7])
    h = h * (math.sqrt(2.0) / 32.0)
    if n == 1:
        return h
    if not 1 < n <= 5:
        raise ValueError(f"coiflet order {n} not supported (1..5)")
    from scipy.optimize import least_squares

    for order in range(2, n + 1):
        length = 6 * order
        idx = np.arange(-2 * order, 4 * order).astype(float)

        def resid(hh, length=length, idx=idx, order=order):
            r = []
            for k in range(3 * order):
                r.append(np.sum(hh[: length - 2 * k] * hh[2 * k:])
                         - (1.0 if k == 0 else 0.0))
            sgn = (-1.0) ** np.arange(length)
            for j in range(2 * order):
                r.append(np.sum(sgn * idx ** j * hh))
            r.append(np.sum(hh) - math.sqrt(2.0))
            for j in range(1, 2 * order):
                r.append(np.sum(idx ** j * hh))
            return np.array(r)

        seed = np.zeros(length)
        seed[2: 2 + len(h)] = h
        sol = least_squares(resid, seed, xtol=3e-16, ftol=3e-16,
                            gtol=3e-16, method="lm")
        if np.abs(resid(sol.x)).max() > 1e-9:  # pragma: no cover
            raise RuntimeError(f"coif{order} solve did not converge")
        h = sol.x
    return h


# -- biorthogonal spline family --------------------------------------------

def _bezout_poly(q: int) -> list:
    """Coefficients C(q-1+k, k), k = 0..q-1, of the Bezout half-band
    polynomial P(y) = Σ C(q-1+k,k) y^k (Daubechies construction)."""
    return [float(math.comb(q - 1 + k, k)) for k in range(q)]


def _poly_in_sin2(coeffs: Sequence[float]) -> np.ndarray:
    """Expand Σ c_k sin^{2k}(ω/2) into a centered Laurent filter."""
    s = np.array([-1.0, 2.0, -1.0]) / 4.0  # sin²(ω/2) as (z^-1, 1, z)
    deg = len(coeffs) - 1
    out = np.zeros(2 * deg + 1)
    for k, ck in enumerate(coeffs):
        term = np.array([ck])
        for _ in range(k):
            term = np.convolve(term, s)
        off = (len(out) - len(term)) // 2
        out[off: off + len(term)] += term
    return out


def spline_bior_filters(nr: int, nd: int):
    """CDF spline biorthogonal pair biorNr.Nd: rec_lo = B-spline(nr),
    dec_lo = complementary factor with nd vanishing moments (closed
    form; reference capability src/2D-DWT.py:22-32 via pywt)."""
    if (nr + nd) % 2:
        raise ValueError("bior orders must have equal parity")
    s2 = math.sqrt(2.0)
    rec_lo = np.array([math.comb(nr, k) for k in range(nr + 1)], float)
    rec_lo *= s2 / 2.0 ** nr
    c = np.array([1.0, 2.0, 1.0]) / 4.0  # cos²(ω/2)
    if nr % 2 == 0:
        a, b = nr // 2, nd // 2
        dec_lo = _poly_in_sin2(_bezout_poly(a + b))
    else:
        a, b = (nr - 1) // 2, (nd - 1) // 2
        dec_lo = np.convolve(
            _poly_in_sin2(_bezout_poly(a + b + 1)), np.array([1.0, 1.0]) / 2.0
        )
    for _ in range(b):
        dec_lo = np.convolve(dec_lo, c)
    dec_lo = dec_lo * s2
    alt = lambda f: np.array([(-1.0) ** k for k in range(len(f))]) * f[::-1]
    return dec_lo, alt(rec_lo), rec_lo, alt(dec_lo)


def cdf97_filters():
    """CDF 9/7 (JPEG2000 irrational) pair — pywt's `bior4.4`.

    Same q=4 Bezout polynomial as the spline 4.4, but factored: the
    real root goes to synthesis, the complex pair to analysis; both
    sides keep a (cos²)² spline factor.
    """
    p = _bezout_poly(4)  # 1 + 4y + 10y² + 20y³
    roots = np.roots(p[::-1])
    real = [r for r in roots if abs(r.imag) < 1e-9]
    cplx = [r for r in roots if abs(r.imag) >= 1e-9]
    # B(y) = 1 - y/r₁ (real root → synthesis); A(y) = Π(1 - y/rᵢ) over
    # the complex pair (→ analysis).  A(0)=B(0)=1 ⇒ A·B = P exactly.
    b_coeffs = [1.0, -1.0 / real[0].real]  # ascending powers of y
    a_coeffs = np.real(
        np.convolve([1.0, -1.0 / cplx[0]], [1.0, -1.0 / cplx[1]])
    )
    s2 = math.sqrt(2.0)
    c = np.array([1.0, 2.0, 1.0]) / 4.0
    dec_lo = _poly_in_sin2(a_coeffs)
    rec_lo = _poly_in_sin2(b_coeffs)
    for _ in range(2):
        dec_lo = np.convolve(dec_lo, c)
        rec_lo = np.convolve(rec_lo, c)
    dec_lo, rec_lo = dec_lo * s2, rec_lo * s2
    alt = lambda f: np.array([(-1.0) ** k for k in range(len(f))]) * f[::-1]
    return dec_lo, alt(rec_lo), rec_lo, alt(dec_lo)


# -- periodization-phase auto-calibration ----------------------------------

def _np_down(x, f, shift):
    z = np.zeros_like(x)
    for j, fj in enumerate(f):
        z = z + np.roll(x, -(j + shift)) * fj
    return z[::2]


def _np_up(a, f, phase, n):
    up = np.zeros(n)
    up[::2] = a
    y = np.zeros(n)
    for j, fj in enumerate(f):
        y = y + np.roll(up, j + phase) * fj
    return y


def _calibrate(dec_lo, dec_hi, rec_lo, rec_hi, name: str) -> Bank:
    """Find periodization shifts/phases giving exact PR (≤1e-8 on a
    random signal); the highpass synthesis sign is folded into rec_hi."""
    rng = np.random.default_rng(42)
    n = 64
    x = rng.normal(size=n)
    lmax = max(len(dec_lo), len(dec_hi), len(rec_lo), len(rec_hi))
    r = range(-(lmax + 2), lmax + 3)
    cl, ch = -(len(dec_lo) // 2), -(len(dec_hi) // 2)
    for sl in (cl, cl + 1):
        lo = _np_down(x, dec_lo, sl)
        for sh in (ch, ch + 1):
            hi = _np_down(x, dec_hi, sh)
            for pl in r:
                ylo = _np_up(lo, rec_lo, pl, n)
                for sgn in (1.0, -1.0):
                    for ph in r:
                        y = ylo + sgn * _np_up(hi, rec_hi, ph, n)
                        if np.abs(y - x).max() < 1e-8:
                            return Bank(dec_lo, dec_hi, rec_lo,
                                        sgn * np.asarray(rec_hi),
                                        shift_lo=sl, shift_hi=sh,
                                        phase_lo=pl, phase_hi=ph)
    raise ValueError(f"no PR phase alignment found for {name!r}")


#: the biorthogonal grid pywt ships (reference -w accepts any of these,
#: src/2D-DWT.py:22-32)
BIOR_ORDERS = {
    (1, 1), (1, 3), (1, 5),
    (2, 2), (2, 4), (2, 6), (2, 8),
    (3, 1), (3, 3), (3, 5), (3, 7), (3, 9),
    (4, 4), (5, 5), (6, 8),
}


@functools.lru_cache(maxsize=None)
def get_bank(name: str) -> Bank:
    if name == "haar":
        name = "db1"
    if name.startswith("db"):
        p = int(name[2:])
        h = daubechies_lowpass(p)
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        # orthonormal: synthesis = adjoint of analysis (same filters,
        # zero phases)
        return Bank(h, g, h, g)
    if name.startswith("sym"):
        h = symlet_lowpass(int(name[3:]))
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        return Bank(h, g, h, g)
    if name.startswith("coif"):
        h = coiflet_lowpass(int(name[4:]))
        g = np.array([(-1) ** k for k in range(len(h))]) * h[::-1]
        return Bank(h, g, h, g)
    if name in ("bior2.2", "legall53"):
        s2 = math.sqrt(2.0)
        dec_lo = np.array([-1, 2, 6, 2, -1], np.float64) / 8.0 * s2
        dec_hi = np.array([-1, 2, -1], np.float64) / 2.0 / s2
        rec_lo = np.array([1, 2, 1], np.float64) / 2.0 / s2
        rec_hi = np.array([-1, -2, 6, -2, -1], np.float64) / 8.0 * s2
        # PR phases found analytically/numerically (tests/test_dwt.py)
        return Bank(dec_lo, dec_hi, rec_lo, rec_hi,
                    shift_lo=-2, shift_hi=0, phase_lo=-1, phase_hi=-1)
    if name in ("cdf97", "jpeg2000"):
        return _calibrate(*cdf97_filters(), name=name)
    if name.startswith(("bior", "rbio")):
        try:
            nr, nd = (int(t) for t in name[4:].split("."))
        except ValueError:
            raise ValueError(f"unknown wavelet {name!r}") from None
        if (nr, nd) not in BIOR_ORDERS:
            raise ValueError(f"unsupported bior orders {name!r}")
        if (nr, nd) == (4, 4):
            filters = cdf97_filters()  # pywt bior4.4 IS the CDF 9/7
        else:
            filters = spline_bior_filters(nr, nd)
        if name.startswith("rbio"):
            dl, dh, rl, rh = filters
            filters = (rl, rh, dl, dh)
        return _calibrate(*filters, name=name)
    raise ValueError(f"unknown wavelet {name!r}")


# ---------------------------------------------------------------------------
# Periodized single-axis filter bank
# ---------------------------------------------------------------------------

def _down_axis(x, filt: np.ndarray, shift: int, axis: int):
    """a[k] = sum_j f[j] * x[(2k + j + shift) mod n] along `axis`."""
    z = None
    for j, fj in enumerate(filt.tolist()):
        term = jnp.roll(x, -(j + shift), axis=axis) * fj
        z = term if z is None else z + term
    idx = jnp.arange(0, x.shape[axis], 2)
    return jnp.take(z, idx, axis=axis)


def _up_axis(a, filt: np.ndarray, phase: int, axis: int, n: int):
    """y[m] += sum_j f[j] * a_up[(m - j - phase) mod n], a_up[2k]=a[k]."""
    am = jnp.moveaxis(a, axis, 0)
    up = jnp.zeros((n,) + am.shape[1:], am.dtype).at[::2].set(am)
    up = jnp.moveaxis(up, 0, axis)
    y = None
    for j, fj in enumerate(filt.tolist()):
        term = jnp.roll(up, j + phase, axis=axis) * fj
        y = term if y is None else y + term
    return y


def analyze_level(x, bank: Bank):
    lo = _down_axis(x, bank.dec_lo, bank.shift_lo, 0)
    hi = _down_axis(x, bank.dec_hi, bank.shift_hi, 0)
    ll = _down_axis(lo, bank.dec_lo, bank.shift_lo, 1)
    lh = _down_axis(lo, bank.dec_hi, bank.shift_hi, 1)
    hl = _down_axis(hi, bank.dec_lo, bank.shift_lo, 1)
    hh = _down_axis(hi, bank.dec_hi, bank.shift_hi, 1)
    return ll, (lh, hl, hh)


def synthesize_level(ll, details, bank: Bank, out_hw):
    lh, hl, hh = details
    h_out, w_out = out_hw
    lo = (_up_axis(ll, bank.rec_lo, bank.phase_lo, 1, w_out)
          + _up_axis(lh, bank.rec_hi, bank.phase_hi, 1, w_out))
    hi = (_up_axis(hl, bank.rec_lo, bank.phase_lo, 1, w_out)
          + _up_axis(hh, bank.rec_hi, bank.phase_hi, 1, w_out))
    return (_up_axis(lo, bank.rec_lo, bank.phase_lo, 0, h_out)
            + _up_axis(hi, bank.rec_hi, bank.phase_hi, 0, h_out))


def halo_sizes(bank: Bank) -> Tuple[int, int]:
    """(before, after) halo rows a shard needs for one analyze level:
    output a[k] reads input rows 2k + j + shift for j in [0, len) and
    both filters, so `before` covers the most negative j + shift and
    `after` the largest."""
    lo_min = min(bank.shift_lo, bank.shift_hi)
    hi_max = max(len(bank.dec_lo) - 1 + bank.shift_lo,
                 len(bank.dec_hi) - 1 + bank.shift_hi)
    return max(0, -lo_min), max(0, hi_max)


def _down_rows_from_ext(ext, filt: np.ndarray, shift: int, before: int,
                        h_local: int):
    """Row-direction analysis on a halo-extended shard: out[k] =
    sum_j f[j] * ext[before + 2k + j + shift] for 2k in [0, h_local)."""
    z = None
    for j, fj in enumerate(filt.tolist()):
        s = before + j + shift
        term = jax.lax.slice_in_dim(ext, s, s + h_local - 1, 2, axis=0) * fj
        z = term if z is None else z + term
    return z


def analyze_level_rows_sharded(x_local, bank: Bank, axis_name: str,
                               n_shards: int):
    """One DWT analysis level with the FRAME'S ROWS sharded across mesh
    axis `axis_name` (SURVEY §5: intra-frame tile sharding needs halo
    exchange for the filter support — the DCT path's block independence
    does not apply here).  Call inside shard_map; x_local is this
    shard's (h_local, w, ...) row slab with h_local even.  Periodic
    boundary handling matches the unsharded `_down_axis` (the halos
    wrap around the mesh axis via lax.ppermute, so shard 0 receives the
    LAST shard's rows exactly like jnp.roll's wraparound).  Returns
    (ll, (lh, hl, hh)), each rows-sharded at h_local // 2."""
    before, after = halo_sizes(bank)
    h_local = x_local.shape[0]
    assert h_local % 2 == 0 and h_local >= max(before, after), (
        h_local, before, after)
    fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    parts = []
    if before:
        parts.append(jax.lax.ppermute(x_local[-before:], axis_name, fwd))
    parts.append(x_local)
    if after:
        parts.append(jax.lax.ppermute(x_local[:after], axis_name, bwd))
    ext = jnp.concatenate(parts, axis=0)
    lo = _down_rows_from_ext(ext, bank.dec_lo, bank.shift_lo, before, h_local)
    hi = _down_rows_from_ext(ext, bank.dec_hi, bank.shift_hi, before, h_local)
    ll = _down_axis(lo, bank.dec_lo, bank.shift_lo, 1)
    lh = _down_axis(lo, bank.dec_hi, bank.shift_hi, 1)
    hl = _down_axis(hi, bank.dec_lo, bank.shift_lo, 1)
    hh = _down_axis(hi, bank.dec_hi, bank.shift_hi, 1)
    return ll, (lh, hl, hh)


def analyze(x, wavelet: str, levels: int):
    """[LL_L, (LH,HL,HH)_L, ..., (LH,HL,HH)_1] like pywt.wavedec2 /
    the reference's list layout (src/2D-DWT.py:113-136)."""
    bank = get_bank(wavelet)
    details = []
    cur = x
    for _ in range(levels):
        cur, d = analyze_level(cur, bank)
        details.append(d)
    return [cur] + details[::-1]


def synthesize(decomp, wavelet: str):
    bank = get_bank(wavelet)
    cur = decomp[0]
    for details in decomp[1:]:
        out_hw = (details[0].shape[0] * 2, details[0].shape[1] * 2)
        cur = synthesize_level(cur, details, bank, out_hw)
    return cur


# ---------------------------------------------------------------------------
# Pipeline flow (invoked from vcf_tpu.pipeline.Codec)
# ---------------------------------------------------------------------------

#: below this many symbols the ctx tables sidecar (n_ctx x larger)
#: outweighs the order-1 stream saving; cgrans stays order-0
CTX_MIN_SYMBOLS = 2_000_000


class DWT:
    def __init__(self, wavelet: str, levels: int):
        self.wavelet = wavelet
        self.levels = levels
        self._analyze = jax.jit(
            functools.partial(analyze, wavelet=wavelet, levels=levels)
        )
        self._synthesize = jax.jit(functools.partial(synthesize, wavelet=wavelet))

    def subband_names(self) -> List[str]:
        """Coarsest-first, matching the reference's stream naming
        `{fn}_LL_{L}`, `{fn}_{LH|HL|HH}_{r}` (src/2D-DWT.py:162-200)."""
        names = [f"LL_{self.levels}"]
        for lvl in range(self.levels, 0, -1):
            names += [f"LH_{lvl}", f"HL_{lvl}", f"HH_{lvl}"]
        return names

    def flatten(self, decomp):
        flat = [decomp[0]]
        for d in decomp[1:]:
            flat.extend(d)
        return flat

    def unflatten(self, flat):
        decomp = [flat[0]]
        for i in range(self.levels):
            decomp.append(tuple(flat[1 + 3 * i : 4 + 3 * i]))
        return decomp

    def encode(self, codec, img: np.ndarray) -> CodeStream:
        cfg = codec.config
        if cfg.entropy in ("grans", "rans", "cgrans") \
                and cfg.quantizer == "deadzone":
            return self.encode_device(codec, img)
        fwd, _ = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
        soff = codec.spatial_offset

        padded = dct_ops.pad_centered(
            jnp.asarray(img, jnp.float32), 1 << self.levels
        )
        ct = fwd(padded - soff)
        flat = self.flatten(self._analyze(ct))
        names = self.subband_names()

        cs = CodeStream()
        cs.put_shape(img.shape)
        for i, (name, band) in enumerate(zip(names, flat)):
            k, qside = codec._quantize(band)
            # LL as uint16, details as uint8, both +128 (src/2D-DWT.py:162-200)
            stored = (k + 128).astype(np.uint16 if i == 0 else np.uint8)
            payload, side = codec.entropy_codec.encode(stored)
            cs[name] = payload
            for sname, blob in side.items():
                cs[f"{name}.{sname}"] = blob
            for sname, arr in qside.items():
                cs.put_array(f"{name}.q_{sname}", arr)
        cs.put_json(PAYLOAD, {
            "subbands": names, "levels": self.levels, "wavelet": self.wavelet,
        })
        return cs

    # ------------------------------------------------------------------
    # Device entropy path (r5, VERDICT r4 missing #1): one dispatch for
    # analyze+quantize+lane, one for the grouped-rANS scan — per-band
    # tables (one rANS group per subband) keep the reference's per-band
    # statistics (src/2D-DWT.py:162-200) without its per-band streams.
    # ------------------------------------------------------------------
    def _build_device_fns(self, codec):
        if getattr(self, "_dev_fns", None) is not None:
            return self._dev_fns
        from vcf_tpu.entropy import dwt_device as dd

        cfg = codec.config
        fwd, inv = color_ops.get(
            cfg.color if cfg.color != "ycocg_r" else "ycocg")
        soff = codec.spatial_offset
        qss = cfg.qss

        def to_bands(img_u8):
            padded = dct_ops.pad_centered(
                img_u8.astype(jnp.float32), 1 << self.levels)
            ct = fwd(padded - soff)
            flat = self.flatten(self._analyze(ct))
            bands = []
            for i, band in enumerate(flat):
                k = jnp.trunc(band / qss).astype(jnp.int32) + 128
                if i == 0:
                    v = k & 0xFFFF
                    bands.append(((v >> 8) & 0xFF).astype(jnp.uint8))
                    bands.append((v & 0xFF).astype(jnp.uint8))
                else:
                    bands.append((k & 0xFF).astype(jnp.uint8))
            return bands

        def make_lanes(img_u8, sg, l):
            return dd.bands_to_grid(to_bands(img_u8), sg, l)

        def from_bands(bands, shapes):
            flat = []
            i = 0
            pos = 0
            while pos < len(bands):
                if i == 0:
                    hi = bands[0].astype(jnp.int32)
                    lo = bands[1].astype(jnp.int32)
                    v = (hi << 8) | lo
                    k = jnp.where(v >= 32768, v - 65536, v) - 128
                    pos = 2
                else:
                    # u8-wrapped stored index: v - 128 lands in [-128, 127]
                    k = bands[pos].astype(jnp.int32) - 128
                    pos += 1
                flat.append(
                    (k.astype(jnp.float32) * qss).reshape(shapes[i]))
                i += 1
            ct = self._synthesize(self.unflatten(flat))
            y = inv(ct) + soff
            return y

        self._dev_fns = (jax.jit(make_lanes, static_argnums=(1, 2)),
                         jax.jit(from_bands, static_argnums=(1,)),
                         to_bands)
        return self._dev_fns

    def _band_shapes(self, img_shape):
        """Padded subband shapes, coarsest-first, matching flatten()."""
        m = 1 << self.levels
        hp = -(-img_shape[0] // m) * m
        wp = -(-img_shape[1] // m) * m
        c = img_shape[2] if len(img_shape) == 3 else 1
        shapes = [(hp >> self.levels, wp >> self.levels, c)]
        for lvl in range(self.levels, 0, -1):
            s = (hp >> lvl, wp >> lvl, c)
            shapes += [s, s, s]
        return shapes

    def encode_device(self, codec, img: np.ndarray) -> CodeStream:
        from vcf_tpu.entropy import dwt_device as dd

        cfg = codec.config
        make_lanes, _, _ = self._build_device_fns(codec)
        shapes = self._band_shapes(img.shape)
        sizes = [int(np.prod(shapes[0]))] * 2 + [
            int(np.prod(s)) for s in shapes[1:]]
        sg, l = dd.grid_dims(sizes)
        lanes = make_lanes(jnp.asarray(img), sg, l)
        g = len(sizes)
        # cgrans: per-(band, prev-class) tables over the lane-major
        # raster layout — captures the zero-run structure order-0
        # misses (~0.9 bpp on detail bands).  Small inputs stay
        # order-0: the n_ctx-x tables sidecar would outweigh the gain.
        n_ctx = 0
        if cfg.entropy == "cgrans" and sum(sizes) >= CTX_MIN_SYMBOLS:
            n_ctx = cfg.context_classes
        if n_ctx:
            fg, cg = dd.train_ctx_tables(lanes, g, n_ctx)
            words, n_words, states, counts = dd.encode_grid_ctx(
                lanes, fg, cg)
        else:
            fg, cg = dd.train_tables(lanes, g)
            words, n_words, states, counts = dd.encode_grid(lanes, fg, cg)

        cs = CodeStream()
        cs.put_shape(img.shape)
        # NB: the DWT schema stores its meta JSON under the "payload"
        # segment name (host-path quirk kept for format stability), so
        # the word stream gets its own segment
        cs["gdwt_words"] = words.astype("<u2").tobytes()
        cs["gdwt_model"] = dd.pack_model(
            g, sg, l, n_words, cfg.qss, states, counts, fg, n_ctx=n_ctx)
        cs.put_json(PAYLOAD, {
            "subbands": self.subband_names(), "levels": self.levels,
            "wavelet": self.wavelet, "device": True,
        })
        return cs

    def decode_device(self, codec, cs: CodeStream) -> np.ndarray:
        from vcf_tpu.entropy import dwt_device as dd

        _, from_bands, _ = self._build_device_fns(codec)
        shape = cs.get_shape()
        shapes = self._band_shapes(shape)
        sizes = [int(np.prod(shapes[0]))] * 2 + [
            int(np.prod(s)) for s in shapes[1:]]
        _, sg, l, n_words, _, states, _, fg, cg, n_ctx = dd.unpack_model(
            cs["gdwt_model"])
        words = np.frombuffer(cs["gdwt_words"], "<u2")[:n_words]
        decode = dd.decode_grid_ctx if n_ctx else dd.decode_grid
        lanes = decode(words, states, fg, cg, l)
        bands = dd.grid_to_bands(lanes, sizes, sg)
        y = from_bands(bands, tuple(shapes))
        y = dct_ops.unpad_centered(y, shape)
        return np.asarray(jnp.clip(jnp.round(y), 0, 255)).astype(np.uint8)

    def decode(self, codec, cs: CodeStream) -> np.ndarray:
        cfg = codec.config
        meta = cs.get_json(PAYLOAD)
        if meta.get("device"):
            return self.decode_device(codec, cs)
        _, inv = color_ops.get(cfg.color if cfg.color != "ycocg_r" else "ycocg")
        soff = codec.spatial_offset

        names = meta["subbands"]
        shape = cs.get_shape()

        flat = []
        for name in names:
            side = {
                sname.split(".", 1)[1]: cs[sname]
                for sname in cs
                if sname.startswith(f"{name}.")
                and not sname.split(".", 1)[1].startswith("q_")
            }
            stored = codec.entropy_codec.decode(cs[name], side)
            qside = {
                sname.split(".q_", 1)[1]: cs.get_array(sname)
                for sname in cs
                if sname.startswith(f"{name}.q_")
            }
            k = stored.astype(np.int32)
            if stored.dtype == np.uint16:
                # undo the uint16 wrap of negative LL indexes
                k = np.where(k >= 32768, k - 65536, k)
            k = k - 128
            band = codec._dequantize(k, qside, k.shape)
            flat.append(jnp.asarray(band, jnp.float32))
        ct = self._synthesize(self.unflatten(flat))
        y = inv(ct) + soff
        y = dct_ops.unpad_centered(y, shape)
        return np.asarray(jnp.clip(jnp.round(y), 0, 255)).astype(np.uint8)
