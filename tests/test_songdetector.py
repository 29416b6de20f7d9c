"""Song detection pipeline + CLI + ConfigFile."""

import numpy as np
import pytest

from audian_tpu.config import ConfigFile
from audian_tpu.analysis.events import (
    threshold_crossings, merge_events, remove_events, widen_events,
    peak_freqs, square_envelope, threshold_estimates, detect_songs, detect,
    bandpass_filter,
)
from audian_tpu.cli import songdetector
from audian_tpu.data import wavio


RATE = 20000.0


def make_song_recording(rng, nsongs=5, carrier=6500.0, amfreq=30.0,
                        amp=0.6, noise=0.02):
    """Chirpy songs: AM-modulated carrier bursts over noise; the
    recording is just long enough for the requested number of songs."""
    dur = 2.0 + 3.3 * nsongs
    n = int(dur * RATE)
    t = np.arange(n) / RATE
    x = noise * rng.standard_normal(n)
    onsets = []
    for k in range(nsongs):
        t0 = 2.0 + 3.3 * k
        sel = (t >= t0) & (t < t0 + 1.2)
        am = 0.5 * (1 + np.sin(2 * np.pi * amfreq * t[sel]))
        x[sel] += amp * am * np.sin(2 * np.pi * carrier * t[sel])
        onsets.append(t0)
    return np.stack([x, 0.5 * x], axis=1), onsets


def test_threshold_crossings_edges():
    on, off = threshold_crossings(np.array([0, 1, 1, 0, 1, 1]), 0.5)
    assert on.tolist() == [1, 4]
    assert off.tolist() == [3, 6]
    on, off = threshold_crossings(np.array([1, 0, 0]), 0.5)
    assert on.tolist() == [0] and off.tolist() == [1]
    on, off = threshold_crossings(np.zeros(5), 0.5)
    assert len(on) == 0 and len(off) == 0


def test_merge_remove_widen():
    on = np.array([10, 30, 100])
    off = np.array([20, 40, 120])
    mon, moff = merge_events(on, off, 15)
    assert mon.tolist() == [10, 100] and moff.tolist() == [40, 120]
    ron, roff = remove_events(mon, moff, 25)
    assert ron.tolist() == [10] and roff.tolist() == [40]
    won, woff = widen_events(ron, roff, 50, 15)
    assert won.tolist() == [0] and woff.tolist() == [50]


def test_peak_freqs(rng):
    rate = 1000.0
    t = np.arange(4000) / rate
    x = np.sin(2 * np.pi * 30.0 * t) + 0.01 * rng.standard_normal(len(t))
    f = peak_freqs([0], [4000], x, rate, freq_resolution=1.0)
    assert f[0] == pytest.approx(30.0, abs=2.0)
    # flat noise has no prominent peak
    f = peak_freqs([0], [4000], rng.standard_normal(4000), rate, thresh=30.0)
    assert np.isnan(f[0])


def test_square_envelope_tracks_amplitude(rng):
    t = np.arange(int(2 * RATE)) / RATE
    x = 0.8 * np.sin(2 * np.pi * 5000.0 * t)[:, None]
    env, envrate = square_envelope(x, RATE, 100.0)
    assert envrate == pytest.approx(1000.0)
    mid = env[len(env) // 4 : -len(env) // 4, 0]
    # the songdetector envelope is 2x the running RMS: sqrt(2) x amplitude
    assert np.median(mid) == pytest.approx(0.8 * np.sqrt(2), rel=0.05)


def test_threshold_estimates_separates_clusters(rng):
    quiet = 0.01 + 0.002 * rng.standard_normal(5000)
    loud = 1.0 + 0.05 * rng.standard_normal(500)
    env = np.concatenate([quiet, loud])[:, None]
    th = threshold_estimates(env)
    assert 0.1 < th[0] < 0.9


def test_detect_pipeline_finds_songs(rng):
    x, true_onsets = make_song_recording(rng)
    result = detect(x, RATE, highpassfreq=5500.0, lowpassfreq=7500.0,
                    envelopecutofffreq=100.0, minduration=0.5)
    for c in range(2):
        assert len(result["onsets"][c]) == len(true_onsets)
        for got, want in zip(result["onsets"][c], true_onsets):
            assert got == pytest.approx(want, abs=0.3)


@pytest.mark.parametrize("amp", [0.6, 0.2, 0.06])
def test_detection_quality_across_snr(rng, amp):
    """Quantified operating envelope for the whole pipeline.  The
    reference ships its threshold heuristic without any validation
    (`songdetector.py:102`, the author's own "XXX improve ... this");
    here ground-truth recordings pin precision AND recall at 100% for
    song amplitudes from 30x down to 3x the broadband noise floor, with
    onsets within 0.3 s.  A quality regression in any stage (band
    filter, envelope, threshold, refinement) breaks this.

    Measured boundary (seed 42): at 2x and below the histogram threshold
    stops separating the clusters and the pipeline goes SILENT — recall
    0, still zero false positives — which is the designed conservative
    failure mode (`threshold_estimates` places the threshold above
    everything when no signal cluster stands out)."""
    x, true_onsets = make_song_recording(rng, amp=amp)
    result = detect(x, RATE, highpassfreq=5500.0, lowpassfreq=7500.0,
                    envelopecutofffreq=100.0, minduration=0.5)
    for c in range(2):
        got = np.asarray(result["onsets"][c])
        matched = np.zeros(len(true_onsets), bool)
        false_pos = 0
        for g in got:
            d = np.abs(np.asarray(true_onsets) - g)
            if d.min() <= 0.3:
                matched[int(d.argmin())] = True
            else:
                false_pos += 1
        recall = matched.mean()
        assert recall == 1.0, (amp, c, got, true_onsets)
        assert false_pos == 0, (amp, c, got)


def test_config_roundtrip(tmp_path):
    cfg = songdetector.default_config()
    assert cfg.value("minduration") == 0.5
    p = tmp_path / "song.cfg"
    cfg.dump(p)
    text = p.read_text()
    assert "highpassfreq: 1000.0Hz" in text
    cfg2 = songdetector.default_config()
    p.write_text(text.replace("minduration: 0.5s", "minduration: 0.25s"))
    cfg2.load(p)
    assert cfg2.value("minduration") == 0.25


def test_config_cascade(tmp_path):
    d = tmp_path / "a" / "b"
    d.mkdir(parents=True)
    (tmp_path / "a" / "x.cfg").write_text("minduration: 0.3s\n")
    (d / "x.cfg").write_text("minduration: 0.2s\n")
    cfg = songdetector.default_config()
    cfg.load_files("x.cfg", d / "data.wav", 3)
    assert cfg.value("minduration") == 0.2  # deepest wins


def test_songdetector_cli(tmp_path, rng, capsys):
    x, true_onsets = make_song_recording(rng, nsongs=3)
    p = tmp_path / "songs.wav"
    wavio.write_audio(p, x, RATE, encoding="FLOAT")
    cfg = tmp_path / "my.cfg"
    assert songdetector.main(["-c", str(cfg)]) == 0
    assert cfg.exists()
    out = tmp_path / "events.csv"
    assert songdetector.main([str(p), "-o", str(out),
                              ]) == 0
    lines = out.read_text().strip().splitlines()
    assert lines[0].startswith("channel,tstart/s")
    assert len(lines) == 1 + 2 * 3  # 3 songs x 2 channels
    # missing file -> error status
    assert songdetector.main([str(tmp_path / "nope.wav")]) == 1


# -- interactive viewer (gui/songplot.py, reference SignalPlot) --------------------


@pytest.fixture(scope="module")
def song_result(rng):
    x, onsets = make_song_recording(rng, nsongs=3)
    result = detect(x, RATE, highpassfreq=5500.0, lowpassfreq=7500.0,
                    envelopecutofffreq=100.0, minduration=0.5)
    return x, result


def test_songplot_render_and_keys(song_result, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from audian_tpu.gui.songplot import SongPlot

    x, result = song_result
    win = SongPlot(x, RATE, result, filename="song.wav")
    assert len(win.axs) == 2

    class Ev:
        def __init__(self, key):
            self.key = key

    # time verbs
    t0, tw = win.toffset, win.twindow
    win.keypress(Ev("+"))
    assert win.twindow == tw / 2
    win.keypress(Ev("pagedown"))
    assert win.toffset > t0
    win.keypress(Ev("home"))
    assert win.toffset == 0.0
    # amplitude verbs
    win.keypress(Ev("Y"))
    assert win.ymax[0] == pytest.approx(0.5)
    win.keypress(Ev("V"))
    assert win.ymax[0] == 1.0
    # layer toggles
    win.keypress(Ev("ctrl+t"))
    assert not win.show_traces
    # interactive envelope redesign re-runs the pipeline
    win.envelopecutofffreq = 100.0
    win.keypress(Ev("e"))
    assert win.envelopecutofffreq == pytest.approx(100.0 / 1.5)
    assert len(win.result["onsets"]) == 2
    # filter redesign
    hp0 = win.highpassfreq
    win.keypress(Ev("h"))
    assert win.highpassfreq == pytest.approx(hp0 / 1.5)
    # waveform + full-figure export
    p = win.save_waveform(tmp_path / "wave.png")
    assert p.exists()
    p2 = win.savefig(tmp_path / "view.png")
    assert p2.exists()


def test_songdetector_cli_plot_png(tmp_path, rng):
    import matplotlib

    matplotlib.use("Agg")
    x, _ = make_song_recording(rng, nsongs=2)
    p = tmp_path / "song.wav"
    wavio.write_audio(p, x, RATE, encoding="PCM_16")
    png = tmp_path / "view.png"
    rc = songdetector.main([str(p), "--plot-png", str(png),
                            "-o", str(tmp_path / "songs.csv")])
    assert rc == 0
    assert png.exists() and (tmp_path / "songs.csv").exists()


def test_band_env_chunked_matches_whole(rng, monkeypatch):
    """Chunked whole-recording detection DSP == single-program output."""
    import jax.numpy as jnp
    import scipy.signal as sps
    from audian_tpu.ops import FilterDesign
    from audian_tpu.analysis import events

    rate = 20000.0
    n = 50000
    x = rng.standard_normal((n, 2))
    fdesign = FilterDesign.from_sos(
        sps.butter(1, (5500.0, 7500.0), "bandpass", fs=rate, output="sos"))
    edesign = FilterDesign.from_sos(
        sps.butter(1, 100.0, "lowpass", fs=rate, output="sos"))
    step = 20
    y_ref, env_ref = events._band_env_device(fdesign, edesign,
                                             jnp.asarray(x))
    y_ref = np.asarray(y_ref)
    env_ref = np.asarray(env_ref[::step])
    monkeypatch.setattr(events, "_CHUNK", 8192)
    y, env = events._band_env_chunks(fdesign, edesign, x, step, True)
    assert y.shape == y_ref.shape and env.shape == env_ref.shape
    np.testing.assert_allclose(y, y_ref, atol=1e-10)
    np.testing.assert_allclose(env, env_ref, atol=1e-10)
    # filtered pull is optional
    y2, env2 = events._band_env_chunks(fdesign, edesign, x, step, False)
    assert y2 is None
    np.testing.assert_allclose(env2, env, atol=0)


def test_band_env_chunked_misaligned_tail(rng, monkeypatch):
    """The tail chunk's window start need not align to the decimation
    grid; the traced-offset strided gather must still hit the global
    grid exactly."""
    import jax.numpy as jnp
    import scipy.signal as sps
    from audian_tpu.ops import FilterDesign
    from audian_tpu.analysis import events

    rate = 20000.0
    n = 50010  # forces hb % step != 0 in the last chunk
    x = rng.standard_normal((n, 1))
    fdesign = FilterDesign.from_sos(
        sps.butter(1, (5500.0, 7500.0), "bandpass", fs=rate, output="sos"))
    edesign = FilterDesign.from_sos(
        sps.butter(1, 100.0, "lowpass", fs=rate, output="sos"))
    step = 20
    y_ref, env_ref = events._band_env_device(fdesign, edesign,
                                             jnp.asarray(x))
    env_ref = np.asarray(env_ref[::step])
    monkeypatch.setattr(events, "_CHUNK", 8192)
    y, env = events._band_env_chunks(fdesign, edesign, x, step, True)
    assert env.shape == env_ref.shape
    np.testing.assert_allclose(env, env_ref, atol=1e-10)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=1e-10)


def test_band_env_scrubs_reuse_chunk_program(rng, monkeypatch):
    """Cutoff scrubs over a multi-chunk recording must not recompile the
    chunked device program (geometry is step/kernel independent; sticky
    kernel budgets absorb pow2 crossings after warmup at the longest
    kernel)."""
    import logging
    import jax
    from audian_tpu.analysis import events

    monkeypatch.setattr(events, "_CHUNK", 1 << 15)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    rate = 20000.0
    x = rng.standard_normal((int(12 * rate), 1)).astype(np.float32)
    # warm up at the longest kernels (lowest cutoffs / narrowest band)
    events.band_env(x, rate, 6000.0, 7500.0, 44.4, return_filtered=False)
    events.band_env(x, rate, 3000.0, 7500.0, 44.4, return_filtered=False)

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
        for envf, hp in ((66.7, 5500.0), (150.0, 5500.0), (100.0, 3200.0),
                         (225.0, 4125.0), (44.4, 6000.0)):
            events.band_env(x, rate, hp, 7500.0, envf,
                            return_filtered=False)
    finally:
        jax.config.update("jax_log_compiles", False)
        for lg in loggers:
            lg.removeHandler(handler)
    big = [r for r in records
           if "Compiling" in r and "_band_env_device" in r]
    assert not big, f"cutoff scrubs recompiled the chunk program: {big[:1]}"


# -- threshold_estimates validation beyond reference parity -----------------------
# The reference marks this heuristic "XXX improve (and proof) this"
# (`songdetector.py:102`) and ships no validation; these pin the properties
# the heuristic must actually deliver.


def test_threshold_no_signal_gives_no_detections(rng):
    """Pure noise must yield thresholds above everything: zero false
    positive songs at any min_duration."""
    env = np.abs(0.01 + 0.002 * rng.standard_normal((20000, 3)))
    th = threshold_estimates(env)
    for c in range(3):
        assert th[c] > env[:, c].max()
    onsets, offsets = detect_songs(env, 1000.0, th, min_duration=0.0)
    assert all(len(o) == 0 for o in onsets)


def test_threshold_separates_across_snr_sweep(rng):
    """For signal clusters from 10x to 1000x the noise floor, the
    threshold lands strictly between the clusters."""
    for snr in (10.0, 100.0, 1000.0):
        noise = np.abs(0.01 + 0.002 * rng.standard_normal(20000))
        sig = 0.01 * snr * (1.0 + 0.05 * rng.standard_normal(2000))
        env = np.concatenate([noise, sig])[:, None]
        (th,) = threshold_estimates(env)
        assert noise.max() < th < sig.min(), (snr, th)


def test_threshold_scale_equivariance(rng):
    """Scaling the envelope scales the threshold: detections are
    amplitude-units independent."""
    noise = np.abs(0.01 + 0.002 * rng.standard_normal(20000))
    sig = 1.0 + 0.05 * rng.standard_normal(2000)
    env = np.concatenate([noise, sig])[:, None]
    (th1,) = threshold_estimates(env)
    (th2,) = threshold_estimates(env * 37.5)
    assert th2 == pytest.approx(37.5 * th1, rel=1e-6)


def test_threshold_dead_channel_among_live(rng):
    """A silent channel between live ones never produces detections and
    never corrupts its neighbors' thresholds."""
    noise = np.abs(0.01 + 0.002 * rng.standard_normal(22000))
    sig = np.concatenate([noise[:20000], 1.0 + 0.05 *
                          rng.standard_normal(2000)])
    env = np.stack([sig, np.zeros(22000), sig], axis=1)
    th = threshold_estimates(env)
    assert th[0] == pytest.approx(th[2])
    onsets, _ = detect_songs(env, 1000.0, th, min_duration=0.0)
    assert len(onsets[0]) > 0 and len(onsets[2]) > 0
    assert len(onsets[1]) == 0


def test_band_env_int16_matches_float(rng, monkeypatch):
    """Raw PCM-16 int16 input (the CLI's raw16 load path) produces the
    same detection DSP as the dequantized float input, on both the
    chunked device path and the small-recording host-scipy path."""
    from audian_tpu.analysis import events

    rate = 20000.0
    n = 50000
    q = np.round(np.clip(0.3 * rng.standard_normal((n, 2)), -1, 1)
                 * 32767).astype(np.int16)
    xf = q.astype(np.float64) / 32768.0
    monkeypatch.setattr(events, "_CHUNK", 8192)
    yq, eq, rq = events.band_env(q, rate, 5500.0, 7500.0, 100.0)
    yf, ef, rf = events.band_env(xf, rate, 5500.0, 7500.0, 100.0)
    assert rq == rf
    np.testing.assert_allclose(np.asarray(yq), np.asarray(yf), atol=1e-7)
    np.testing.assert_allclose(np.asarray(eq), np.asarray(ef), atol=1e-7)
    # host-scipy small-recording path
    yq2, eq2, _ = events.band_env(q[:4000], rate, 5500.0, 7500.0, 100.0)
    yf2, ef2, _ = events.band_env(xf[:4000], rate, 5500.0, 7500.0, 100.0)
    np.testing.assert_allclose(yq2, yf2, atol=1e-12)
    np.testing.assert_allclose(eq2, ef2, atol=1e-12)


def test_songdetector_cli_raw16(tmp_path, rng, capsys):
    """The CLI's raw int16 load path produces the same song table as a
    float decode of the same PCM-16 file."""
    from audian_tpu.data import wavio
    from audian_tpu.data.loader import AudioLoader
    from audian_tpu.cli import songdetector

    x, _ = make_song_recording(rng, nsongs=2)
    p = tmp_path / "songs16.wav"
    wavio.write_audio(p, x, RATE, encoding="PCM_16")
    ld = AudioLoader(p, prefetch=False)
    assert ld.raw16_capable
    ld.close()
    out = tmp_path / "songs.csv"
    assert songdetector.main(["-o", str(out), str(p)]) == 0
    lines = out.read_text().strip().splitlines()
    assert lines[0].startswith("channel,tstart/s")
    assert len(lines) == 1 + 2 * 2  # 2 songs x 2 channels


def test_config_tolerates_bad_values(tmp_path, capsys):
    """Hand-edited config files with malformed values warn and keep the
    defaults instead of killing the batch run (thunderlab semantics)."""
    from audian_tpu.cli.songdetector import default_config

    cfg = default_config()
    want = cfg.value("minduration")
    bad = tmp_path / "songdetector.cfg"
    bad.write_text("minduration: abc\n"
                   "highpassfreq:\n"
                   "lowpassfreq: 9000Hz # inline comment\n")
    cfg.load(bad)
    err = capsys.readouterr().err
    assert "minduration" in err and "highpassfreq" in err
    assert cfg.value("minduration") == want
    assert cfg.value("lowpassfreq") == 9000.0  # comment stripped


def test_bandpass_defaults_survive_low_rates(rng):
    """Default band edges above Nyquist must clamp keeping lowf < highf
    (both edges used to collapse to the same value and crash scipy)."""
    x = (0.1 * rng.standard_normal((4000, 1))).astype(np.float32)
    y = bandpass_filter(x, 10000.0)  # defaults 5500/7500 vs nyq 5000
    assert y.shape == x.shape
    res = detect(x, 8000.0, highpassfreq=4000.0, lowpassfreq=6000.0,
                 return_filtered=False)
    assert res["onsets"] is not None


def test_threshold_constant_channel_sentinel(rng):
    """A channel pinned at the global max (clipped) gets the silent
    sentinel threshold, not NaN (which silently dropped every event)."""
    env = np.column_stack([np.full(1000, 3.0),
                           0.1 * np.abs(rng.standard_normal(1000))])
    th = threshold_estimates(env)
    assert np.isfinite(th[0]) and th[0] > 3.0
    assert np.isfinite(th[1])


def test_songplot_end_key_exact_multiple(rng):
    """'end' must land on the last window WITH data when the duration is
    an exact multiple of twindow (it used to page fully past the data)."""
    import matplotlib
    matplotlib.use("Agg")
    from audian_tpu.gui.songplot import SongPlot

    rate = 8000.0
    n = int(64.0 * rate)  # duration 64 s -> twindow 64 s (pow2 ceil)
    x = (0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    res = detect(x, rate, return_filtered=True)
    sp = SongPlot(x, rate, res, filename="end.wav")

    class K:
        def __init__(s, k):
            s.key = k

    sp.keypress(K("end"))
    duration = n / rate
    assert sp.toffset < duration  # window still overlaps the data
    sp.plt.close(sp.fig)


def test_identical_songs_all_detected(tmp_path):
    """Three identical pulse-train songs must ALL be detected: the
    reference's outlier cleaning (`songdetector.py:155-175`) collapses to
    zero tolerance when the inner-quartile envelope-frequency spread is
    ~0 and arbitrarily drops songs; the rebuild floors the tolerance at
    1% of the mean envelope frequency."""
    from audian_tpu.data import wavio
    from audian_tpu.analysis import events

    rate = 48000
    t = np.arange(int(20.0 * rate)) / rate
    rng2 = np.random.default_rng(7)
    song = np.zeros_like(t)
    for s in (2.0, 7.5, 14.0):
        m = (t >= s) & (t < s + 1.5)
        song[m] = (np.sin(2 * np.pi * 6000 * t[m])
                   * (0.5 + 0.5 * np.sign(np.sin(2 * np.pi * 20 * t[m]))))
    x = song + 0.02 * rng2.standard_normal(t.size)
    res = events.detect(x[:, None].astype(np.float64), float(rate),
                        return_filtered=False)
    onsets = np.asarray(res["onsets"][0])
    assert len(onsets) == 3, onsets
    np.testing.assert_allclose(onsets, [2.0, 7.5, 14.0], atol=0.1)


def test_band_env_fused_matches_unfused(rng, monkeypatch):
    """The decimating fused batch path (ops/envdet.py) reproduces the
    exact chunked driver: interior chunks to kernel-truncation f32
    tolerance, edge chunks bit-identically (they share the exact path —
    scipy's padlen+zi edge semantics survive)."""
    import scipy.signal as sps
    from audian_tpu.analysis import events

    rate = 20000.0
    n = 50000
    x = rng.standard_normal((n, 2))
    monkeypatch.setattr(events, "_CHUNK", 8192)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    y_ref, env_ref, r_ref = events.band_env(
        x, rate, 5500.0, 7500.0, 100.0, return_filtered=False)
    y_f, env_f, r_f = events.band_env(
        x, rate, 5500.0, 7500.0, 100.0, return_filtered=False, fused=True)
    assert y_f is None and r_f == r_ref
    assert env_f.shape == env_ref.shape
    scale = np.abs(env_ref).max()
    np.testing.assert_allclose(env_f, env_ref, atol=1e-5 * scale)
    # scipy float64 oracle end to end (including the recording edges)
    want_y = sps.sosfiltfilt(
        sps.butter(1, (5500.0, 7500.0), "bandpass", fs=rate, output="sos"),
        x, axis=0)
    want_e = 2.0 * sps.sosfiltfilt(
        sps.butter(1, 100.0, "lowpass", fs=rate, output="sos"),
        want_y ** 2, axis=0)
    want = np.sqrt(np.maximum(want_e, 0.0))[::20] * np.sqrt(2.0)
    np.testing.assert_allclose(env_f, want, atol=2e-5 * scale)


def test_band_env_fused_int16_and_tail(rng, monkeypatch):
    """Fused path: raw PCM-16 windows dequantize on device (k/2^15) and a
    misaligned tail still lands on the global decimation grid."""
    from audian_tpu.analysis import events

    rate = 20000.0
    n = 50010  # forces off0 % step != 0 in later chunks
    x = (0.3 * rng.standard_normal((n, 1))).astype(np.float64)
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    xq = q.astype(np.float64) / 32768.0
    monkeypatch.setattr(events, "_CHUNK", 8192)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    _, env_ref, _ = events.band_env(xq, rate, 5500.0, 7500.0, 100.0,
                                    return_filtered=False)
    _, env_q, _ = events.band_env(q, rate, 5500.0, 7500.0, 100.0,
                                  return_filtered=False, fused=True)
    assert env_q.shape == env_ref.shape
    scale = np.abs(env_ref).max()
    np.testing.assert_allclose(env_q, env_ref, atol=1e-5 * scale)


def test_detect_fused_same_songs(rng, monkeypatch):
    """detect() with return_filtered=False (the batch CLI path, fused
    envelope) finds exactly the same songs as the plot path."""
    from audian_tpu.analysis import events

    rate = 20000.0
    t = np.arange(int(rate * 16)) / rate
    x = 0.02 * rng.standard_normal(len(t))
    for s in (3.0, 9.0):
        m = (t >= s) & (t < s + 1.5)
        am = 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[m]))
        x[m] += 0.6 * am * np.sin(2 * np.pi * 6500.0 * t[m])
    monkeypatch.setattr(events, "_CHUNK", 1 << 15)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    full = events.detect(x, rate, 5500.0, 7500.0, 100.0,
                         return_filtered=True)
    fast = events.detect(x, rate, 5500.0, 7500.0, 100.0,
                         return_filtered=False)
    assert fast["filtered"] is None
    for key in ("onset_indices", "offset_indices"):
        for cf, cr in zip(fast[key], full[key]):
            np.testing.assert_array_equal(cf, cr)


def test_envdet_precision_knob(rng, monkeypatch):
    """EnvDet(precision=DEFAULT) stays within ~1e-3 relative of the
    HIGHEST default (on a GPU DEFAULT may run the dots in TF32)."""
    from jax import lax
    import scipy.signal as sps
    from audian_tpu.ops import FilterDesign
    from audian_tpu.ops.envdet import EnvDet

    rate = 20000.0
    n = 40000
    x = rng.standard_normal((n, 2)).astype(np.float32)
    fdesign = FilterDesign.from_sos(
        sps.butter(1, (5500.0, 7500.0), "bandpass", fs=rate, output="sos"))
    edesign = FilterDesign.from_sos(
        sps.butter(1, 100.0, "lowpass", fs=rate, output="sos"))
    hi = EnvDet(fdesign, edesign, 20, 512, hb=4096)
    lo = EnvDet(fdesign, edesign, 20, 512, hb=4096,
                precision=lax.Precision.DEFAULT)
    a = np.asarray(hi(x, 4100))
    b = np.asarray(lo(x, 4100))
    scale = np.abs(a).max()
    assert np.abs(a - b).max() < 0.01 * scale  # loose bf16 budget


@pytest.mark.parametrize("step", [1, 3, 7])
def test_envdet_edge_steps(rng, step):
    """EnvDet matches the float64 scipy oracle for degenerate and
    non-dividing decimation steps (step=1 means no decimation), at an
    offset that is not on the first window's decimation grid."""
    import scipy.signal as sps
    from audian_tpu.analysis import events
    from audian_tpu.ops import FilterDesign
    from audian_tpu.ops.envdet import EnvDet

    rate = 8000.0
    x = rng.standard_normal((40000, 2)).astype(np.float32)
    fd = FilterDesign.from_sos(
        sps.butter(1, (1500.0, 3000.0), "bandpass", fs=rate,
                   output="sos"))
    ed = FilterDesign.from_sos(
        sps.butter(1, 900.0, "lowpass", fs=rate, output="sos"))
    hb = 2048
    nout = 2048 // step
    off0 = hb + step - 1
    got = np.asarray(EnvDet(fd, ed, step, nout, hb)(x, off0))
    _y, ref = events.detect_env_oracle(x.astype(np.float64), 1, fd, ed)
    ref = ref[off0 : off0 + nout * step : step]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
