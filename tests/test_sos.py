"""Golden-value tests for the SOS IIR kernels against scipy oracles.

These implement SURVEY.md section 4 item 1: every kernel vs. its scipy
oracle within 1e-5 (and much tighter in float64).
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp

from audian_tpu.ops import (
    design_filter,
    design_envelope_filter,
    fir_kernels,
    sosfilt,
    sosfilt_fir,
    sosfiltfilt,
    sosfilt_zi,
    odd_ext,
)


RATE = 48000.0


def _sos_cases():
    return {
        "bandpass": design_filter(RATE, 2000.0, 10000.0, order=2),
        "highpass": design_filter(RATE, 500.0, None, order=2),
        "lowpass": design_filter(RATE, 0.0, 8000.0, order=3),
        "envelope": design_envelope_filter(RATE, 500.0),
        "env_band": design_envelope_filter(RATE, 500.0, highpass_cutoff=50.0),
    }


@pytest.fixture(scope="module", params=list(_sos_cases()))
def sos(request):
    return _sos_cases()[request.param]


@pytest.fixture(scope="module")
def signal(rng):
    n = 50000
    t = np.arange(n) / RATE
    x = (
        np.sin(2 * np.pi * 4000.0 * t)
        + 0.5 * np.sin(2 * np.pi * 300.0 * t)
        + 0.2 * rng.standard_normal(n)
    )
    return x


def test_design_passthrough():
    assert design_filter(RATE, 0.0, RATE / 2) is None
    assert design_filter(RATE, 0.0, None) is None


def test_design_modes():
    assert design_filter(RATE, 1000.0, None) is not None
    assert design_filter(RATE, 0.0, 1000.0) is not None
    assert design_filter(RATE, 100.0, 1000.0).shape == (2, 6)
    assert design_envelope_filter(RATE, -5.0) is None  # infeasible


def test_sosfilt_matches_scipy_f64(sos, signal):
    got = np.asarray(sosfilt(sos, signal))
    want = sps.sosfilt(sos, signal)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def _f32_scan_atol(sos):
    # The associative-scan path loses f32 precision for near-unit-circle
    # poles (very low band edges); production uses the FIR path there
    # (see test_sosfilt_fir_f32_production_accuracy).
    from audian_tpu.ops import sos_pole_radius

    return 2e-2 if sos_pole_radius(sos) > 0.995 else 2e-4


def test_sosfilt_f32_tolerance(sos, signal):
    got = np.asarray(sosfilt(sos, signal.astype(np.float32)))
    want = sps.sosfilt(sos, signal)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=_f32_scan_atol(sos))


def test_sosfilt_fir_f32_production_accuracy(sos, signal):
    """The production (FIR matmul) path stays within 1e-5 of the float64
    scipy oracle even in float32 — the BASELINE.md numerical target."""
    k = fir_kernels(sos, eps=1e-9)
    got = np.asarray(sosfilt_fir(k, signal.astype(np.float32)))
    want = sps.sosfilt(sos, signal)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sosfilt_multichannel_axis(sos, signal):
    x = np.stack([signal, signal[::-1], 0.5 * signal], axis=1)
    got = np.asarray(sosfilt(sos, x, axis=0))
    want = sps.sosfilt(sos, x, axis=0)
    np.testing.assert_allclose(got, want, atol=1e-9)
    got_t = np.asarray(sosfilt(sos, x.T, axis=1))
    np.testing.assert_allclose(got_t, want.T, atol=1e-9)


def test_sosfilt_blocked_equals_unblocked(sos, signal):
    a = np.asarray(sosfilt(sos, signal, block_size=1 << 20))
    b = np.asarray(sosfilt(sos, signal, block_size=1111))
    np.testing.assert_allclose(a, b, atol=1e-9)


def test_sosfilt_zi_roundtrip(sos, signal):
    """Chunked streaming with carried state equals one-shot filtering."""
    zi = np.zeros((len(np.atleast_2d(sos)), 2))
    y1, zf = sosfilt(sos, signal[:20000], zi=zi)
    y2, _ = sosfilt(sos, signal[20000:], zi=zf)
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    want = sps.sosfilt(sos, signal)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_sosfilt_zi_matches_scipy(sos, signal):
    zi0 = sps.sosfilt_zi(np.atleast_2d(sos)) * signal[0]
    got, gzf = sosfilt(sos, signal, zi=zi0)
    want, wzf = sps.sosfilt(np.atleast_2d(sos), signal, zi=zi0)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gzf), wzf, atol=1e-9)


def test_sosfilt_zi_helper_matches_scipy(sos):
    got = np.asarray(sosfilt_zi(sos))
    want = sps.sosfilt_zi(np.atleast_2d(sos))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_odd_ext_matches_scipy(signal):
    from scipy.signal._arraytools import odd_ext as scipy_odd_ext

    got = np.asarray(odd_ext(signal[:100], 9))
    want = scipy_odd_ext(signal[:100], 9)
    np.testing.assert_allclose(got, want)
    x2 = np.stack([signal[:50], signal[50:100]], axis=1)
    got2 = np.asarray(odd_ext(x2, 7, axis=0))
    want2 = scipy_odd_ext(x2, 7, axis=0)
    np.testing.assert_allclose(got2, want2)


def test_sosfiltfilt_matches_scipy(sos, signal):
    got = np.asarray(sosfiltfilt(sos, signal))
    want = sps.sosfiltfilt(sos, signal)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_sosfiltfilt_multichannel(sos, signal):
    x = np.stack([signal, 0.3 * signal[::-1]], axis=1)
    got = np.asarray(sosfiltfilt(sos, x, axis=0))
    want = sps.sosfiltfilt(sos, x, axis=0)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_sosfiltfilt_f32(sos, signal):
    got = np.asarray(sosfiltfilt(sos, signal.astype(np.float32)))
    want = sps.sosfiltfilt(sos, signal)
    np.testing.assert_allclose(got, want, rtol=0, atol=40 * _f32_scan_atol(sos))


def test_sosfilt_traced_coefficients_no_recompile(signal):
    """Scrubbing a cutoff re-runs the same compiled program: coefficients
    are traced args, so the jit cache sees one entry for many designs."""
    compiled = jax.jit(lambda s, x: sosfilt(s, x))
    x = jnp.asarray(signal[:5000])
    sos1 = jnp.asarray(design_filter(RATE, 1000.0, 8000.0))
    sos2 = jnp.asarray(design_filter(RATE, 2000.0, 6000.0))
    y1 = compiled(sos1, x)
    y2 = compiled(sos2, x)
    assert compiled._cache_size() == 1
    np.testing.assert_allclose(
        np.asarray(y1), sps.sosfilt(np.array(sos1), signal[:5000]), atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(y2), sps.sosfilt(np.array(sos2), signal[:5000]), atol=1e-9
    )


def test_sosfiltfilt_sym_interior_matches_scipy(sos, signal):
    from audian_tpu.ops import filtfilt_sym_kernel, sosfiltfilt_sym

    g, delay = filtfilt_sym_kernel(sos, eps=1e-9)
    got = np.asarray(sosfiltfilt_sym(g, delay, signal))
    want = sps.sosfiltfilt(sos, signal)
    assert got.shape == want.shape
    # edges follow zero padding; interior must match tightly
    np.testing.assert_allclose(got[delay:-delay], want[delay:-delay],
                               atol=1e-6)


def test_sosfiltfilt_sym_multichannel(sos, signal):
    from audian_tpu.ops import filtfilt_sym_kernel, sosfiltfilt_sym

    g, delay = filtfilt_sym_kernel(sos, eps=1e-9)
    x = np.stack([signal, 0.5 * signal[::-1]], axis=1)
    got = np.asarray(sosfiltfilt_sym(g, delay, x, axis=0))
    want = sps.sosfiltfilt(sos, x, axis=0)
    np.testing.assert_allclose(got[delay:-delay], want[delay:-delay],
                               atol=1e-6)


# --- FIR fast path ---------------------------------------------------------


def test_sosfilt_fir_matches_scipy(sos, signal):
    k = fir_kernels(sos, eps=1e-9)
    got = np.asarray(sosfilt_fir(k, signal))
    want = sps.sosfilt(sos, signal)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sosfilt_fir_with_state_streaming(sos, signal):
    k = fir_kernels(sos, eps=1e-10)
    zi = np.zeros((len(np.atleast_2d(sos)), 2))
    y1, zf = sosfilt_fir(k, signal[:30000], zi=zi)
    y2, _ = sosfilt_fir(k, signal[30000:], zi=np.asarray(zf))
    got = np.concatenate([np.asarray(y1), np.asarray(y2)])
    want = sps.sosfilt(sos, signal)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sosfilt_fir_multichannel(sos, signal):
    k = fir_kernels(sos, eps=1e-9)
    x = np.stack([signal, 0.5 * signal[::-1]], axis=1)
    got = np.asarray(sosfilt_fir(k, x, axis=0))
    want = sps.sosfilt(sos, x, axis=0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sosfilt_fir_random_designs(rng):
    """Fuzz the FIR production path over random Butterworth designs
    (order 1-4, low/high/band, cutoffs across the band) against the
    scipy float64 oracle at the 1e-5 contract."""
    import scipy.signal as sps
    from audian_tpu.ops import FilterDesign, sosfiltfilt_fir

    n = 20000
    x = rng.standard_normal((n, 2))
    x64 = x.astype(np.float64)
    for k in range(8):
        order = int(rng.integers(1, 5))
        kind = ["lowpass", "highpass", "bandpass"][k % 3]
        lo = float(rng.uniform(200.0, 4000.0))
        hi = float(rng.uniform(lo * 1.8, 20000.0))
        wn = (lo, hi) if kind == "bandpass" else (lo if kind == "highpass"
                                                  else hi)
        sos = sps.butter(order, wn, kind, fs=RATE, output="sos")
        d = FilterDesign.from_sos(sos)
        got = np.asarray(sosfiltfilt_fir(
            d.fir, jnp.asarray(x, jnp.float32), d.zi0, d.padlen, axis=0))
        want = sps.sosfiltfilt(sos, x64, axis=0)
        scale = max(np.max(np.abs(want)), 1e-9)
        err = np.max(np.abs(got - want)) / scale
        assert err <= 1e-5, (kind, order, wn, err)


def test_sosfilt_fir_short_block_streaming(signal):
    """Blocks SHORTER than the truncated kernel must carry the initial
    state (A**n @ s0) into the final conditions — streaming in small
    blocks equals one whole-signal scipy run."""
    sos = design_envelope_filter(RATE, 100.0)  # kernel length ~2.5k taps
    k = fir_kernels(sos, eps=1e-10)
    block = 512
    assert block < k.length
    zi = np.zeros((len(np.atleast_2d(sos)), 2))
    outs = []
    x = signal[:8192]
    for i in range(0, len(x), block):
        y, zi = sosfilt_fir(k, x[i : i + block], zi=np.asarray(zi))
        outs.append(np.asarray(y))
    got = np.concatenate(outs)
    want = sps.sosfilt(sos, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_negative_axis_with_zi_matches_scipy(rng):
    """axis=-1 with scipy-convention zi must match scipy (the zi/zf
    moveaxis used 1+axis, which silently corrupted negative axes)."""
    from audian_tpu.ops import fir_kernels, sosfilt_fir, sosfilt

    sos = sps.butter(2, [0.1, 0.4], "bandpass", output="sos")
    x = rng.standard_normal((3, 400))
    zi = np.repeat(sps.sosfilt_zi(sos)[:, None], 3, axis=1)
    want, want_zf = sps.sosfilt(sos, x, zi=zi, axis=-1)
    got, got_zf = sosfilt(sos, x, zi=zi, axis=-1)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_zf), want_zf, atol=1e-6)
    k = fir_kernels(sos, eps=1e-9)
    got2, got2_zf = sosfilt_fir(k, x, zi=zi, axis=-1)
    np.testing.assert_allclose(np.asarray(got2), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got2_zf), want_zf, atol=1e-5)


def test_odd_ext_too_long_raises():
    from audian_tpu.ops import odd_ext

    with pytest.raises(ValueError, match="too big"):
        odd_ext(np.arange(5.0), 7)


def test_envelope_design_clamps_near_dc():
    """Near-DC envelope cutoffs clamp to a floor so the truncated-FIR
    kernel stays bounded (a 1 Hz cutoff at 96 kHz would need ~350k taps
    and a ~1 GB Toeplitz bank); non-positive stays infeasible."""
    from audian_tpu.ops import design_envelope_filter
    from audian_tpu.ops.design import effective_impulse_length

    sos = design_envelope_filter(96000.0, envelope_cutoff=1.0)
    assert sos is not None
    assert effective_impulse_length(sos, 2e-6) < 40000
    assert design_envelope_filter(96000.0, 0.0) is None
