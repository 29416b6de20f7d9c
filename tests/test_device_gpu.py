"""Device-numerics suite for the GPU (opt-in).

The regular suite runs on a virtual CPU mesh where every float32 dot is
exact float32; it cannot observe what the card's compiler and libraries
do (a float32 dot without a precision may run in TF32 there).  This
module pins the ON-DEVICE accuracy contract — device f32 within 1e-5 of
scipy float64 — at real widths.  Run it on a machine with a GPU:

    AUDIAN_DEVICE_TESTS=1 python -m pytest -m gpu tests/test_device_gpu.py -q

(the root conftest then leaves the platform alone).  Elsewhere every
test here skips: the ``gpu`` fixture decides at run time, never at
import.
"""

import numpy as np
import pytest
import scipy.signal as sig

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

RATE = 96000.0
C, N = 16, 1 << 18


@pytest.fixture(scope="module")
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("device suite: needs a GPU (AUDIAN_DEVICE_TESTS=1)")
    import audian_tpu

    audian_tpu.enable_compilation_cache()


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(0)
    t = np.arange(N) / RATE
    tone = 0.4 * np.sin(2 * np.pi * 30000.0 * t) * (
        np.sin(2 * np.pi * 5.0 * t) > 0)
    return (tone[None, :]
            + 0.05 * rng.standard_normal((C, N))).astype(np.float32)


@pytest.fixture(scope="module")
def fused(gpu):
    from audian_tpu.models import get_preset

    return get_preset("bioacoustics").fused(RATE, eps=2e-6)


def test_chain_matches_scipy_float64_on_device(fused, signal):
    """The production batch chain (16 channels) on the card vs scipy
    float64 oracles — the 1e-5 contract where TF32 is possible."""
    from audian_tpu.ops import design_filter, design_envelope_filter

    x_ext = np.pad(signal, [(0, 0), (fused.hb, fused.ha)])
    y, e, s = fused.chain_cf(jnp.asarray(x_ext), N)
    y, e, s = np.asarray(y), np.asarray(e), np.asarray(s)

    sos_f = np.asarray(design_filter(RATE, 2000.0, 40000.0), np.float64)
    sos_e = np.asarray(design_envelope_filter(RATE, 500.0), np.float64)
    x64 = x_ext.astype(np.float64)
    y64 = sig.sosfilt(sos_f, x64, axis=1)
    v64 = (np.pi / 2) * np.abs(y64)
    e64 = np.maximum(
        sig.sosfiltfilt(sos_e, v64, axis=1, padtype=None), 0.0)
    y64 = y64[:, fused.hb : fused.hb + N]
    e64 = e64[:, fused.hb : fused.hb + N]

    assert np.max(np.abs(y - y64)) < 1e-5
    assert np.max(np.abs(e - e64)) < 1e-5

    _f, _t, S = sig.spectrogram(
        y64, fs=RATE, window="hann", nperseg=256, noverlap=128,
        detrend=False, mode="psd", axis=1)
    ref = S.transpose(2, 0, 1)[: s.shape[0]]
    got = s[: ref.shape[0]]
    mask = ref > ref.max() * 1e-6  # within 60 dB of the peak
    ddb = np.abs(10 * np.log10(np.maximum(got, 1e-30))
                 - 10 * np.log10(np.maximum(ref, 1e-30)))[mask].max()
    assert ddb < 0.05  # u8 display tiles step ~0.3 dB


def test_interactive_browser_on_device(gpu, tmp_path):
    """Product-level interactive session on the card: open a PCM-16
    recording through the public :class:`DataBrowser`, scroll, scrub the
    filter, pull render tiles — windowed trace reads stay within the
    1e-5 contract of scipy float64 oracles, and once warm the steady
    state compiles nothing (the interactivity contract)."""
    import logging

    from audian_tpu.app import DataBrowser
    from audian_tpu.data import wavio
    from audian_tpu.ops import design_filter

    rate = 48000.0
    rng = np.random.default_rng(3)
    n = int(10.0 * rate)
    t = np.arange(n) / rate
    x = np.stack([
        0.4 * np.sin(2 * np.pi * 9000.0 * t) * (
            np.sin(2 * np.pi * 4.0 * t) > 0)
        + 0.05 * rng.standard_normal(n),
        0.3 * np.sin(2 * np.pi * 5000.0 * t),
    ], axis=1)
    p = tmp_path / "dev.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    x16, _ = wavio.load_audio(p)  # ground truth after PCM-16 quantization

    b = DataBrowser(str(p))
    b.open()

    def interact(k):
        b.set_times(0.5 + 0.6 * k, 1.0)
        b.update_filter(highpass_cutoff=1500.0 + 100.0 * (k % 3),
                        lowpass_cutoff=20000.0)
        for c in range(2):
            b.trace_tile("filtered", c)
            b.spec_tile(c, quantize=True)
        b.power_spectrum(0)

    for k in range(4):  # warmup: compile every program variant
        interact(k)

    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Grab()
    loggers = [logging.getLogger("jax._src.dispatch"),
               logging.getLogger("jax._src.interpreters.pxla")]
    jax.config.update("jax_log_compiles", True)
    try:
        for lg in loggers:
            lg.addHandler(handler)
        for k in range(4, 8):
            interact(k)
    finally:
        jax.config.update("jax_log_compiles", False)
        for lg in loggers:
            lg.removeHandler(handler)
    compiles = [r for r in records if "Compiling" in r or "compilation" in r]
    assert not compiles, f"steady state recompiled on device: {compiles[:4]}"

    # windowed read of the filtered trace vs the scipy float64 oracle
    b.set_times(2.0, 1.0)
    tr = b.data["filtered"]
    i0, i1 = int(2.0 * rate), int(3.0 * rate)
    got = np.asarray(tr[i0:i1])
    sos = np.asarray(design_filter(rate, 1500.0 + 100.0 * (7 % 3),
                                   20000.0), np.float64)
    want = sig.sosfilt(sos, x16.astype(np.float64), axis=0)[i0:i1]
    assert np.max(np.abs(got - want)) < 1e-5
    b.close()


def test_fir_filter_matches_scipy_on_device(gpu, signal):
    """The standalone production FIR path (ops public API) on device."""
    from audian_tpu.ops import design_filter, fir_kernels, sosfilt_fir

    sos = design_filter(RATE, 2000.0, 10000.0)
    y = np.asarray(sosfilt_fir(fir_kernels(sos), jnp.asarray(signal),
                               axis=1))
    y64 = sig.sosfilt(np.asarray(sos, np.float64),
                      signal.astype(np.float64), axis=1)
    # truncated-FIR design tolerance + device f32: the 1e-5 contract
    assert np.max(np.abs(y - y64)) < 1e-5


def test_batch_detect_envelope_on_device(gpu):
    """Batch detection (the ``audian-songdetector`` hot path) vs the
    scipy float64 oracle over a recording long enough for interior
    chunks to take the fused decimating path (``EnvDet``), int16 raw
    input: pins the 1e-5 contract on the card, chunk-edge exact patches
    included."""
    import scipy.signal as sps

    from audian_tpu.analysis import events

    rng = np.random.default_rng(7)
    n = 3 * events._CHUNK + 12345
    t = np.arange(n) / RATE
    tone = 0.4 * np.sin(2 * np.pi * 5000.0 * t) * (
        np.sin(2 * np.pi * 3.0 * t) > 0)
    x = tone[:, None] + 0.03 * rng.standard_normal((n, 2))
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)

    hp, lp, envcut = 1000.0, 10000.0, 500.0
    _f, env, envrate = events.band_env(q, RATE, hp, lp, envcut,
                                       return_filtered=False, fused=True)
    # the same designs band_env builds (sticky pow2 budgets start fresh
    # per process; constructing after the call yields identical lengths)
    fdesign = events.FilterDesign.from_sos(
        sps.butter(1, events._clamp_band(hp, lp, RATE), "bandpass",
                   fs=RATE, output="sos"),
        pad_to=events._KERNEL_BUDGET["filt"] or None)
    edesign = events.FilterDesign.from_sos(
        sps.butter(1, events._clamp_cutoff(envcut, RATE), "lowpass",
                   fs=RATE, output="sos"),
        pad_to=events._KERNEL_BUDGET["env"] or None)
    step = int(np.round(RATE / min(envcut * 10, RATE)))
    assert envrate == RATE / step
    x64 = q.astype(np.float64) / 32768.0
    _y, env64 = events.detect_env_oracle(x64, step, fdesign, edesign)
    assert env.shape == env64.shape
    assert np.max(np.abs(env - env64)) < 1e-5


def test_window_matmul_odd_geometries_on_device(gpu):
    """Non-pow2 hops / kernel rows / output widths on the card."""
    from audian_tpu.ops.window_matmul import window_matmul

    rng = np.random.default_rng(11)
    for S, K, O, layout in ((26, 256, 129, "fco"), (32, 64, 32, "cf"),
                            (128, 1408, 128, "cf"), (90, 512, 129, "fco")):
        Cc, n = 16, 40000
        x = jnp.asarray(rng.standard_normal((Cc, n)).astype(np.float32))
        w = jnp.asarray(rng.standard_normal((K, O)).astype(np.float32))
        nframes = (n - K) // S + 1
        out = np.asarray(window_matmul(x, w, S, nframes,
                                       out_layout=layout))
        xn = np.asarray(x, np.float64)
        wn = np.asarray(w, np.float64)
        ref = np.stack([xn[:, f * S : f * S + K] @ wn
                        for f in range(nframes)])
        if layout == "cf":
            out = (out[:, : nframes * O].reshape(Cc, nframes, O)
                   .transpose(1, 0, 2))
        scale = max(np.max(np.abs(ref)), 1e-9)
        err = np.max(np.abs(out - ref)) / scale
        assert err < 1e-5, f"S={S} K={K} O={O} {layout}: {err}"


def test_devicewatch_on_device(gpu):
    """The device-loss watchdog's probe and guarded pull on the card:
    the probe compiles once and answers inside the heartbeat deadline
    afterwards; a guarded pull of a real device reduction completes
    without flipping the state.  (The loss and recovery machinery is
    fault-injection-tested in the CPU suite, tests/test_devicewatch.py.)"""
    import time as _time

    from audian_tpu.utils.devicewatch import DeviceWatch

    w = DeviceWatch()
    assert w._probe_alive(), "first (compile-inclusive) probe failed"
    assert w._probe_warmed
    t0 = _time.monotonic()
    assert w._probe_alive()
    warm_s = _time.monotonic() - t0
    assert warm_s < 5.0, f"warm heartbeat took {warm_s:.1f}s"
    x = jnp.ones((256, 256), jnp.float32)
    got = w.pull(lambda: float(np.asarray(jnp.sum(x))), what="test sum")
    assert got == 65536.0
    assert not w.lost
