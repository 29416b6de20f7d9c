"""Adversarial edge cases across the stack."""

import numpy as np
import pytest
import scipy.signal as sps

from audian_tpu.ops import (design_filter, fir_kernels, sosfilt, sosfilt_fir,
                            spectrogram, minmax_interleaved)
from audian_tpu.ops.window_matmul import window_matmul
from audian_tpu.data import Data, default_traces, wavio
from audian_tpu.graph import (TraceGraph, TraceSpec, GraphExecutor,
                              FilterNode, SpectrogramNode)

import jax.numpy as jnp

RATE = 48000.0


def test_sosfilt_short_signals():
    sos = design_filter(RATE, 1000.0, 8000.0)
    x = np.random.default_rng(0).standard_normal(5)
    np.testing.assert_allclose(np.asarray(sosfilt(sos, x)),
                               sps.sosfilt(sos, x), atol=1e-9)
    k = fir_kernels(sos, eps=1e-9)  # kernel longer than the signal
    np.testing.assert_allclose(np.asarray(sosfilt_fir(k, x)),
                               sps.sosfilt(sos, x), atol=1e-6)


def test_sosfilt_fir_zi_axis1():
    sos = design_filter(RATE, 1000.0, 8000.0)
    k = fir_kernels(sos, eps=1e-9)
    x = np.random.default_rng(1).standard_normal((3, 4000))
    zi = np.zeros((len(sos), 3, 2))
    got, gzf = sosfilt_fir(k, x, zi=zi, axis=1)
    want, wzf = sps.sosfilt(sos, x, zi=np.zeros((len(sos), 3, 2)), axis=1)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gzf), wzf, atol=1e-6)


def test_spectrogram_signal_shorter_than_nfft():
    x = np.zeros(100, np.float32)
    s = np.asarray(spectrogram(x, RATE, 256, 128))
    assert s.shape[0] == 0


def test_minmax_single_sample():
    out = np.asarray(minmax_interleaved(np.array([[3.0]]), 10))
    assert out.shape == (2, 1)
    assert out[0, 0] == out[1, 0] == 3.0


def test_window_matmul_single_frame():
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 512))
                    .astype(np.float32))
    w = jnp.asarray(np.random.default_rng(1).standard_normal((256, 128))
                    .astype(np.float32))
    y = np.asarray(window_matmul(x, w, 128, 1))
    want = np.asarray(x)[:, :256].astype(np.float64) @ np.asarray(w)
    np.testing.assert_allclose(y[0], want, atol=1e-4)


def test_window_matmul_odd_geometries(rng):
    """Non-pow2 hops / kernel rows / output widths (90 % overlap
    spectrograms, truncated banks, K not a multiple of S) match the
    dense float64 oracle in both layouts."""
    for S, K, O, layout in ((26, 256, 129, "fco"), (20, 250, 65, "fco"),
                            (32, 64, 32, "cf"), (90, 512, 129, "cf"),
                            (7, 130, 17, "fco")):
        C, n = 3, 4000
        x = jnp.asarray(rng.standard_normal((C, n)).astype(np.float32))
        w = jnp.asarray(rng.standard_normal((K, O)).astype(np.float32))
        nframes = (n - K) // S + 1
        out = np.asarray(window_matmul(x, w, S, nframes,
                                       out_layout=layout))
        xn = np.asarray(x, np.float64)
        wn = np.asarray(w, np.float64)
        ref = np.stack([xn[:, f * S : f * S + K] @ wn
                        for f in range(nframes)])
        if layout == "cf":
            out = (out[:, : nframes * O].reshape(C, nframes, O)
                   .transpose(1, 0, 2))
        np.testing.assert_allclose(out, ref, atol=2e-4,
                                   err_msg=f"S={S} K={K} O={O} {layout}")


def test_envelope_window_shorter_than_padlen(rng):
    """A source window shorter than the filtfilt pad must yield zeros on
    BOTH the device and host paths (the reference clamps likewise) —
    not a trace-time ValueError from sosfiltfilt."""
    from audian_tpu.graph import EnvelopeNode

    g = TraceGraph([FilterNode("filtered"),
                    EnvelopeNode("envelope", "filtered")])
    n = 9  # <= the default design's padlen
    g.open(TraceSpec(rate=RATE, channels=2, frames=n))
    g["envelope"].update(envelope_cutoff=500.0)
    g.refold()
    x = rng.standard_normal((n, 2)).astype(np.float32)
    ex = GraphExecutor(g)
    out_d = ex.run(jnp.asarray(x), 0, targets=["envelope"])
    out_h = ex.run_host(x, 0, targets=["envelope"])
    env_d = np.asarray(out_d["envelope"][1])
    env_h = np.asarray(out_h["envelope"][1])
    assert env_d.shape == env_h.shape
    np.testing.assert_array_equal(env_d, 0.0)
    np.testing.assert_array_equal(env_h, 0.0)


def test_graph_window_at_recording_end(rng):
    g = TraceGraph([FilterNode("filtered"),
                    SpectrogramNode("spectrogram", "filtered")])
    n = 10000
    g.open(TraceSpec(rate=RATE, channels=1, frames=n))
    g["filtered"].update(highpass_cutoff=1000.0, lowpass_cutoff=8000.0)
    g.refold()
    x = rng.standard_normal((n, 1)).astype(np.float32)
    ex = GraphExecutor(g)
    out = ex.run(x[8000:], 8000, device=False)
    off, arr = out["filtered"]
    # output extends to the recording end despite missing warm-up
    assert off + len(arr) == n
    off_s, sxx = out["spectrogram"]
    assert off_s + len(sxx) == g["spectrogram"].spec.frames


def test_data_window_past_eof(tmp_path, rng):
    x = 0.1 * rng.standard_normal((4000, 1))
    p = tmp_path / "short.wav"
    wavio.write_audio(p, x, 1000.0, encoding="FLOAT")
    d = Data(p)
    for nd in default_traces():
        d.add_trace(nd)
    d.open()
    d.update_times(3.0, 10.0)  # extends past the 4 s recording
    f = d["filtered"]
    assert f.offset + len(f.buffer) <= f.frames
    seg = f[3900:4000]
    assert seg.shape[0] == 100
    region = d.get_region(3.9, 5.0, 0)  # region clipped at EOF
    t, y = region["filtered"]
    assert t[-1] <= 4.0
    d.close()


def test_save_region_channel_subset(tmp_path, rng):
    x = 0.1 * rng.standard_normal((8000, 3))
    p = tmp_path / "multi.wav"
    wavio.write_audio(p, x, 1000.0, encoding="FLOAT")
    from audian_tpu.app import DataBrowser

    b = DataBrowser(p).open()
    b.select_channels([0, 2])
    out = b.save_region(1.0, 2.0, tmp_path / "cut.wav")
    data, rate = wavio.load_audio(out)
    assert data.shape == (1000, 2)
    np.testing.assert_allclose(data[:, 1], x[1000:2000, 2], atol=1e-6)
    b.close()


def test_spectrogram_overlap_extremes_via_trace(tmp_path, rng):
    x = 0.1 * rng.standard_normal((40000, 1))
    p = tmp_path / "ov.wav"
    wavio.write_audio(p, x, 8000.0, encoding="FLOAT")
    d = Data(p)
    for nd in default_traces():
        d.add_trace(nd)
    d.open()
    s = d["spectrogram"]
    s.update(overlap_frac=0.0)   # hop == nfft
    assert s.hop == s.nfft
    d.update_times(0.0, 1.0)
    assert len(s.buffer) > 0
    s.update(overlap_frac=0.999)  # clamps, hop >= 1
    assert s.hop >= 1
    d.close()


def test_out_of_range_cutoffs_never_crash(tmp_path, rng):
    """Interactive cutoff scrubbing must clamp, not raise
    (the reference's spin boxes clamp; headless callers have no box)."""
    from audian_tpu.app import DataBrowser
    from audian_tpu.data import wavio

    rate = 8000.0
    x = 0.1 * rng.standard_normal((8000, 1))
    p = tmp_path / "r.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(p).open()
    try:
        b.update_filter(highpass_cutoff=5000.0)       # > Nyquist
        b.update_filter(highpass_cutoff=-10.0)        # negative
        b.update_filter(lowpass_cutoff=9000.0)        # > Nyquist
        b.update_filter(highpass_cutoff=3000.0,
                        lowpass_cutoff=2000.0)        # inverted band
        b.set_times(0.0, 0.5)
        times, values = b.trace_tile("filtered", 0)
        assert len(times) > 0 and np.all(np.isfinite(values))
    finally:
        b.close()
