"""Headless DataBrowser controller: region verbs, analyzers, plugins,
markers, playback — the reference DataBrowser's GUI-independent surface."""

import numpy as np
import pytest

from audian_tpu.app import DataBrowser, MarkerData, MarkerLabel, secs_to_str
from audian_tpu.analysis import Plugins, Analyzer
from audian_tpu.data import wavio
from audian_tpu.graph import EnvelopeNode


RATE = 44100.0


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory, cricket_like):
    x, rate = cricket_like
    p = tmp_path_factory.mktemp("browser") / "song.wav"
    locs = np.array([[1000, 500]])
    labels = np.array([["song", "a chirp"]], dtype=object)
    md = {"BEXT": {"OriginationDate": "2026-05-05",
                   "OriginationTime": "06:07:08"}}
    wavio.write_audio(p, x, rate, metadata=md, locs=locs, labels=labels,
                      encoding="PCM_16")
    return p


@pytest.fixture()
def browser(wav_file):
    plugins = Plugins()
    plugins.add_trace_factory(
        lambda b: b.add_trace(EnvelopeNode("envelope", "filtered")))
    b = DataBrowser(wav_file, plugins=plugins).open()
    yield b
    b.close()


def test_open_defaults(browser):
    assert set(browser.data.keys()) == {"data", "filtered", "spectrogram",
                                        "envelope"}
    assert browser.show_channels == [0, 1]
    assert browser.twindow == 2.0
    # markers loaded from the file metadata
    assert len(browser.marker_data) == 1
    assert browser.marker_data.labels[0] == "song"
    # analyzers: plain + statistics
    names = [a.name for a in browser.analyzers]
    assert names[:2] == ["plain", "statistics"]


def test_time_verbs(browser):
    browser.set_times(0.0, 1.0)
    browser.time_page_down()
    assert browser.toffset == pytest.approx(0.5)
    browser.time_zoom_in()
    assert browser.twindow == pytest.approx(0.5)
    browser.time_end()
    assert browser.toffset + browser.twindow == pytest.approx(2.0, abs=1e-3)
    browser.time_home()
    assert browser.toffset == 0.0


def test_analyze_region(browser):
    browser.update_filter(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    browser.analyze(0.5, 0.6, 0)
    plain = browser.analyzers[0]
    assert plain.data.rows[-1][:2] == [0.5, 0.6]
    stats = browser.analyzers[1]
    mean, std = stats.data.rows[-1]
    assert abs(mean) < 0.1 and 0.0 < std < 1.0


def test_custom_analyzer_events(browser):
    class PeakAnalyzer(Analyzer):
        def __init__(self, b):
            super().__init__(b, "peaks", "filtered")
            self.make_column("peak", "V", "%.3f")
            self.make_trace_events("peaks", "filtered", "o", "red", 5)

        def analyze(self, t0, t1, channel, traces):
            t, y = traces["filtered"]
            i = int(np.argmax(y))
            self.store(float(y[i]))
            self.set_events("peaks", channel, [t[i]], [y[i]])

    pa = PeakAnalyzer(browser)
    browser.analyze(0.1, 0.2, 1)
    assert len(pa.data) == 1
    assert len(pa.events["peaks"][1].x) == 1
    assert len(pa.events["peaks"][0].x) == 0  # other channel cleared


def test_playback(browser):
    play, rate = browser.play_region(0.2, 0.4)
    assert rate == RATE
    assert play.shape == (int(0.2 * RATE), 2)
    assert abs(play[0]).max() == 0.0  # faded in
    browser.set_audio(use_heterodyne=True, heterodyne_freq=4800.0)
    play2, rate2 = browser.play_region(0.2, 0.4)
    assert rate2 == RATE  # no decimation below 40 kHz
    assert play2.shape[1] == 2


def test_save_region_roundtrip(browser, tmp_path):
    out = browser.save_region(0.0, 0.1, tmp_path / "cut.wav")
    data, rate, md, locs, labels, = wavio.load_wav(out)
    assert rate == RATE
    assert data.shape[0] == int(0.1 * RATE)
    # history appended, start time kept (t0=0)
    assert "cut out" in md["BEXT"]["CodingHistory"]
    # marker at frames 1000-1500 is inside [0, 4410)
    assert len(locs) == 1 and locs[0, 0] == 1000 and locs[0, 1] == 500
    assert labels[0, 0] == "song"


def test_save_region_shifts_markers_and_time(browser, tmp_path):
    out = browser.save_region(0.01, 0.2, tmp_path / "cut2.wav")
    _, _, md, locs, _ = wavio.load_wav(out)
    assert locs[0, 0] == 1000 - int(round(0.01 * RATE))
    t = wavio.get_datetime(md)
    assert t.second == 8  # shifted by 0.01 s only -> still 06:07:08


def test_render_tiles(browser):
    browser.set_times(0.0, 1.0)
    times, values = browser.trace_tile("filtered", 0)
    assert len(times) == len(values) > 0
    img, rect = browser.spec_tile(0)
    assert img.ndim == 2 and img.shape[1] == 129
    zmin, zmax = browser.estimate_power_levels(0)
    assert 20 <= zmax - zmin <= 80


def test_channels(browser):
    browser.set_channels([1])
    assert browser.show_channels == [1]
    assert browser.current_channel == 1
    # second show_channel on the lone shown channel restores all
    # (`src/audian/databrowser.py:1496-1505`)
    browser.show_channel(1)
    assert browser.show_channels == [0, 1]


def test_marker_data_roundtrip(tmp_path):
    md = MarkerData()
    md.add_data(0, 1.5, delta_time=0.5, label="song", text="x")
    md.add_data(1, 2.0, amplitude=0.3, frequency=4800.0, power=-20.0)
    locs, labels = md.get_markers(1000.0)
    assert locs[0].tolist() == [1000, 500]
    md2 = MarkerData()
    md2.set_markers(locs, labels, 1000.0)
    assert md2.times[0] == pytest.approx(1.5)
    path = md.save(tmp_path / "events.csv")
    text = path.read_text()
    assert "time/s" in text and "song" in text


def test_secs_to_str():
    assert secs_to_str(0) == "0s"
    assert secs_to_str(65) == "1m05s"
    assert secs_to_str(3605) == "1h00m05s"


def test_power_spectrum(browser):
    browser.set_times(0.3, 0.8)
    freqs, db = browser.power_spectrum(0)
    assert len(freqs) == len(db) == 129
    # the 4.8 kHz carrier dominates the spectrum
    assert freqs[np.argmax(db)] == pytest.approx(4800.0, abs=200.0)


def test_mark_audio_ticks(browser):
    browser.play_region(0.5, 0.7)
    assert browser.audio_time == pytest.approx(0.5)
    t = browser.mark_audio()
    assert t == pytest.approx(0.55)
    browser.set_audio(rate_fac=2.0, dispatch=False)
    t = browser.mark_audio()
    assert t == pytest.approx(0.575)
    browser.audio_time = 0.69
    browser.set_audio(rate_fac=1.0, dispatch=False)
    assert browser.mark_audio() is None  # past the end -> stopped
    assert browser.audio_time == -1.0


def test_time_info_rows(browser):
    rows = browser.time_info(65.5)
    kinds = [r[0] for r in rows]
    assert kinds[0] == "REC"
    assert rows[0][2].startswith("1:05.5")
    assert "Time" in kinds  # file has a BEXT start time
    abs_row = rows[kinds.index("Time")]
    assert abs_row[2].startswith("2026-05-05 6:08:13")


# -- interactivity contract: steady state never recompiles --------------------


def test_no_recompiles_in_steady_state(tmp_path, rng):
    """After warmup, scrolling and parameter scrubbing reuse compiled
    programs (CLAUDE.md architecture invariant). Counts actual XLA
    compilations via jax's compile logging."""
    import logging
    import jax

    rate = 8000.0
    x = (0.3 * np.sin(2 * np.pi * 440.0 *
                      np.arange(int(30.0 * rate)) / rate)
         + 0.02 * rng.standard_normal(int(30.0 * rate)))
    x = np.stack([x, 0.5 * x], axis=1)
    p = tmp_path / "nr.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)

    def interact(k):
        # scroll at constant zoom (set_times takes offset, WINDOW LENGTH)
        b.set_times(2.0 + 0.7 * k, 2.0)
        b.update_filter(highpass_cutoff=100.0 + 10.0 * (k % 3))
        b.update_envelope(400.0 + 25.0 * (k % 3))
        for c in range(2):
            b.trace_tile("filtered", c)
            b.spec_tile(c)
        b.power_spectrum(0)
        b.estimate_power_levels(1)

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
        for k in range(4, 10):
            interact(k)
    finally:
        jax.config.update("jax_log_compiles", False)
        for lg in loggers:
            lg.removeHandler(handler)
    compiles = [r for r in records if "Compiling" in r or "compilation" in r]
    assert not compiles, f"steady state recompiled: {compiles[:4]}"
    b.close()


def test_steady_state_pull_budget(tmp_path, rng):
    """Steady-state interaction pulls only pixel-sized tiles across the
    host link — guards against reintroducing whole-window transfers
    (the naive auto-level path pulled ~200 MB per redraw)."""
    from audian_tpu.utils import trace as tr

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(30.0 * rate), 2))
    p = tmp_path / "pb.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)

    def view(k):
        b.set_times(2.0 + 0.7 * k, 2.0)
        for c in range(2):
            b.trace_tile("filtered", c)
            b.spec_tile(c, quantize=True)
        b.estimate_power_levels(0)

    view(0)
    tr.enable(log=False)
    tr.clear()
    try:
        for k in range(1, 6):
            view(k)
        pulls = tr.events("render.pull")
    finally:
        tr.disable()
    total = sum(e["bytes"] for e in pulls)
    # 5 interactions x (1 multi-channel trace tile + 1 u8 image stack +
    # level stats): a few hundred KB total, nowhere near window size
    window_bytes = b.data["filtered"].buffer.size * 4
    assert total < 1_200_000, f"pulled {total} bytes in steady state"
    assert total < window_bytes / 10
    assert all(e["bytes"] < 300_000 for e in pulls)
    # trace tiles cross the link quantized (scale-packed int16 kernels):
    # half the f32 bytes on the latency-dominant scrub path
    trace_pulls = [e for e in pulls if "tile" in e["op"]
                   and "db" not in e["op"]]
    assert trace_pulls
    assert all(e["op"].endswith("_i16") for e in trace_pulls)
    b.close()


def test_hover_power_block_cache(tmp_path, rng):
    """Hover power readouts match direct buffer indexing and sweep the
    cursor through one cached block pull instead of one device round
    trip per mouse-motion event."""
    from audian_tpu.utils import trace as tr

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(10.0 * rate), 2))
    p = tmp_path / "hp.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)
    panel = b.panels.get("spectrogram")
    spec = b.data["spectrogram"]
    freqs = spec.frequencies
    t, f = 1.0, float(freqs[len(freqs) // 2])
    got = panel.get_power(0, t, f)
    i = int(t * spec.rate) - spec.offset
    j = int(np.argmin(np.abs(freqs - f)))
    want = 10 * np.log10(
        max(float(np.asarray(spec.buffer[i, 0, j])), 1e-20))
    assert got == pytest.approx(want, abs=1e-6)
    tr.enable(log=False)
    tr.clear()
    try:
        for k in range(25):
            assert panel.get_power(0, t + 0.01 * k, f) is not None
        pulls = [e for e in tr.events("render.pull")
                 if e["op"] == "power_block"]
    finally:
        tr.disable()
    assert len(pulls) <= 1, f"hover sweep re-pulled {len(pulls)} blocks"
    b.close()


def test_hover_readout_resolves_custom_spectrogram_panel(tmp_path, rng):
    """The spectrogram dB hover resolves the panel through the trace's
    own ``.panel`` — plugin chains may name it something other than
    "spectrogram" (`databrowser.py:243-245` routing)."""
    from audian_tpu.graph import FilterNode, SpectrogramNode

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(5.0 * rate), 1))
    p = tmp_path / "custom_panel.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    plugins = Plugins()
    plugins.clear_trace_factories()

    def traces(b):
        b.add_trace(FilterNode("filtered", "data"))
        b.add_trace(SpectrogramNode("spectrogram", "filtered",
                                    panel="myspec"))

    plugins.add_trace_factory(traces)
    b = DataBrowser(str(p), plugins=plugins).open()
    try:
        b.set_times(0.0, 2.0)
        spec = b.data["spectrogram"]
        fmid = float(spec.frequencies[len(spec.frequencies) // 2])
        line = b.hover_readout(1.0, fmid, kind="spec", channel=0)
        assert "dB" in line, line
    finally:
        b.close()


def test_secs_to_str_fractional():
    assert secs_to_str(90.25) == "1m30.25s"
    assert secs_to_str(5.25) == "5.25s"
    assert secs_to_str(3605.5) == "1h00m05.5s"
    assert secs_to_str(60.5) == "1m00.5s"


def test_browser_without_spectrogram(tmp_path, rng):
    """Recordings with no spectrogram trace must not crash the tile /
    power verbs."""
    from audian_tpu.analysis import Plugins
    from audian_tpu.graph import FilterNode

    p = tmp_path / "nospec.wav"
    wavio.write_audio(p, rng.standard_normal((8000, 1)) * 0.1, 8000.0,
                      encoding="FLOAT")
    plugins = Plugins()
    plugins.trace_factories = [
        lambda b: b.add_trace(FilterNode("filtered", "data"))]
    b = DataBrowser(p, plugins=plugins)
    b.open()
    b.set_times(0.0, 0.5)
    img, rect = b.spec_tile(0)
    assert img.size == 0
    freqs, db = b.power_spectrum(0)
    assert len(freqs) == 0
    assert b.estimate_power_levels(0) == (-100.0, 0.0)
    b.close()


def test_nfft_scrub_zero_compiles_after_warmup(tmp_path, rng):
    """No resolution keypress ANYWHERE in the UI ladder compiles after
    the warm: `warm_resolutions` now defaults to the reference's full
    2^3..2^19 range (clamped by recording length, core band first —
    `DataBrowser.warm_ladder`), the step verbs stay on that pow2 ladder,
    and scrubbing end-to-end is pure cache hits (`databrowser.py:516,
    1188-1222` recomputes per tick in the reference)."""
    import logging
    import jax

    rate = 8000.0
    x = (0.3 * np.sin(2 * np.pi * 440.0 *
                      np.arange(int(30.0 * rate)) / rate)
         + 0.02 * rng.standard_normal(int(30.0 * rate)))
    x = np.stack([x, 0.5 * x], axis=1)
    p = tmp_path / "nfftwarm.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)
    warmed = b.warm_resolutions()
    # 30 s x 8 kHz admits buckets 8..65536: the FULL clamped ladder
    assert warmed == 14
    assert b._warmed_nffts == {2 ** k for k in range(3, 17)}
    assert b.warm_resolutions() == 0  # idempotent

    trace = b.data[b.spectrogram]

    def pull():
        b.spec_tile(0)
        b.spec_tile(0, quantize=True)  # what the GUIs pull
        b.power_spectrum(0)

    def scrub():
        # climb to the clamped top of the ladder, then walk down to the
        # reference UI floor (2^3), pulling at every bucket
        visited = {trace.nfft}
        while True:
            before = trace.nfft
            b.freq_resolution_up()
            if trace.nfft == before:
                break  # verb refuses to leave the warmed pow2 ladder
            visited.add(trace.nfft)
            pull()
        assert trace.nfft == 65536  # largest pow2 <= frames // 2
        while trace.nfft > 8:
            b.freq_resolution_down()
            visited.add(trace.nfft)
            pull()
        b.freq_resolution_down()
        assert trace.nfft == 8  # verb refuses to go below the UI floor
        assert visited == b._warmed_nffts

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
        scrub()
    finally:
        jax.config.update("jax_log_compiles", False)
        for lg in loggers:
            lg.removeHandler(handler)
    compiles = [r for r in records if "Compiling" in r or "compilation" in r]
    assert not compiles, f"NFFT scrub recompiled: {compiles[:4]}"
    b.close()


def test_step_mid_warm_snaps_to_nearest_warmed(tmp_path, rng):
    """While the background warm is still filling the ladder, a step
    into an unwarmed bucket is served by the nearest warmed bucket
    immediately and swaps to the requested one via
    poll_pending_resolution once its programs land (VERDICT r3 #4)."""
    rate = 8000.0
    x = 0.2 * rng.standard_normal(int(10.0 * rate))
    p = tmp_path / "snap.wav"
    wavio.write_audio(p, x[:, None], rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)

    class AliveThread:
        def is_alive(self):
            return True

    b._warm_thread = AliveThread()
    b._warmed_nffts = {256, 512}
    b.set_resolution(nfft=2048)
    # nearest warmed by log distance: 512 (2 octaves) beats 256 (3)
    assert b.data[b.spectrogram].nfft == 512
    assert b.has_pending_resolution and b._pending_nfft == 2048
    assert not b.poll_pending_resolution()  # still unwarmed: keep 512
    assert b.data[b.spectrogram].nfft == 512
    b._warmed_nffts.add(2048)  # the warm thread lands the bucket
    assert b.poll_pending_resolution()
    assert b.data[b.spectrogram].nfft == 2048
    assert not b.has_pending_resolution
    # the step verbs route through the same snap, and repeated steps
    # accumulate on the REQUESTED bucket, not the displayed stand-in
    b._warmed_nffts = {2048}
    b.freq_resolution_up()
    assert b.data[b.spectrogram].nfft == 2048  # snapped back
    assert b._pending_nfft == 4096
    b.freq_resolution_up()
    assert b._pending_nfft == 8192
    b.freq_resolution_down()
    assert b._pending_nfft == 4096
    # a dead warm thread must not pin the view to the stale bucket
    b._warm_thread = None
    assert b.poll_pending_resolution()
    assert b.data[b.spectrogram].nfft == 4096
    # steps with no warm in flight apply directly, no pending
    b.freq_resolution_down()
    assert b.data[b.spectrogram].nfft == 2048
    assert not b.has_pending_resolution
    # a keypress BEFORE the warm lands its FIRST bucket must not
    # compile inline either: the current bucket counts as warmed, the
    # view stays put, the request pends (review finding)
    b._warmed_nffts = set()
    b._warm_thread = AliveThread()
    b.freq_resolution_up()
    assert b.data[b.spectrogram].nfft == 2048
    assert b._pending_nfft == 4096
    b._warm_thread = None
    b.close()


def test_marker_nan_time_export(browser, tmp_path):
    """Frequency-only markers (no time) export at position 0 instead of
    crashing int(nan); the result table rejects over-long rows loudly."""
    md = browser.marker_data
    n0 = len(md)
    md.add_data(0, None, frequency=1234.0, label="f")
    locs, labels = md.get_markers(browser.data.rate)
    assert locs[n0, 0] == 0 and locs[n0, 1] == 0
    md.remove(n0)


def test_result_table_row_column_contracts():
    from audian_tpu.analysis.table import ResultTable

    t = ResultTable()
    t.append("a")
    t.append("b", "s", "%.2f")
    with pytest.raises(ValueError):
        t.add([1, 2, 3])  # more values than columns: loud, not silent
    t.add([1, 2])
    t.append("c")  # column after rows: existing rows padded
    assert t.rows[0] == [1, 2, None]
    t.add([4, 5, 6])
    df = t.to_dataframe()
    c = list(df["c"])
    assert (c[0] is None or np.isnan(c[0])) and c[1] == 6
    assert t.formatted(0) == ["1", "2.00", ""]


def test_find_label_case_insensitive():
    from audian_tpu.app.markers import MarkerLabel, find_label, key_conflicts

    labels = [MarkerLabel("song", "Ctrl+S", "red"),
              MarkerLabel("noise", "", "gray"),
              MarkerLabel("call", "", "blue")]
    assert find_label(labels, "ctrl+s").label == "song"
    assert key_conflicts(labels) == {}  # empty keys never conflict


def test_long_session_caches_stay_bounded(tmp_path, rng):
    """A long interactive session (scrolls, scrubs, hovers, channel and
    NFFT changes) must not grow any of the private caches past their
    documented bounds — regressions here leak device windows or host
    tiles over hours of use."""
    from audian_tpu.view import render

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(20.0 * rate), 2))
    p = tmp_path / "long.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)
    spec = b.data["spectrogram"]
    fmid = float(spec.frequencies[len(spec.frequencies) // 2])
    r = np.random.default_rng(7)
    for k in range(60):
        t0 = float(r.uniform(0.0, 17.0))
        b.set_times(t0, float(r.uniform(0.5, 2.5)))
        for c in range(2):
            b.trace_tile("filtered", c)
            b.spec_tile(c, quantize=True)
        if k % 7 == 0:
            b.update_filter(highpass_cutoff=float(r.uniform(100, 900)))
        if k % 11 == 0:
            b.hover_readout(t0 + 0.2, fmid, kind="spec", channel=0)
        if k % 13 == 0:
            b.auto_ampl()
    assert len(b.trace_tiler._cache) <= 32
    assert len(b.spec_tiler._cache) <= 8
    assert len(render._extrema_cache) <= 64
    assert len(render._power_block_cache) <= 16
    assert len(b.data._q_staging) <= 4
    b.close()


def test_first_nfft_step_compiles_only_its_bucket(tmp_path, rng):
    """The first resolution keypress after open must not warm the whole
    sweep inline (a cold compile cache would stall the keypress for
    the length of the compiles): it compiles at most its own
    bucket, and the full sweep warms in the BACKGROUND through a
    throwaway clone that never touches this browser's state."""
    rate = 8000.0
    x = (0.3 * np.sin(2 * np.pi * 440.0 *
                      np.arange(int(20.0 * rate)) / rate)
         + 0.02 * rng.standard_normal(int(20.0 * rate)))
    p = tmp_path / "warmasync.wav"
    wavio.write_audio(p, x[:, None], rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()
    b.set_times(0.0, 2.0)
    b.spec_tile(0)  # settle the initial bucket's programs
    nfft0 = b.data[b.spectrogram].nfft
    n0 = b.data.executor.cache_size
    b.freq_resolution_up()
    b.spec_tile(0)
    assert b.data[b.spectrogram].nfft == 2 * nfft0
    # exactly the new bucket's program was added — not the whole sweep
    assert b.data.executor.cache_size <= n0 + 1
    assert not b._resolutions_warmed

    th = b.warm_resolutions_async()
    assert th is not None
    th.join(timeout=600)
    assert not th.is_alive()
    # the clone warmed the caches without touching this browser's state
    assert b.data[b.spectrogram].nfft == 2 * nfft0
    assert b.data.executor.cache_size <= n0 + 1
    # warming again on this browser is now served from warm caches and
    # leaves its own sweep programs compiled
    assert b.warm_resolutions() > 0
    assert b.warm_resolutions_async() is None  # already warm
    b.close()


def test_scroll_delta_tile_pulls(tmp_path, rng):
    """A half-window scroll re-pulls only the newly exposed tile
    columns (render caches key on global columns + content epoch, not
    whole windows): bytes pulled are well under 60% of a full-window
    pull, and the assembled tiles equal a fresh full pull."""
    from audian_tpu.utils import trace as tr
    from audian_tpu.view.render import TraceTiler, SpecTiler

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(30.0 * rate), 2))
    p = tmp_path / "delta.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p))
    b.open()

    def view(t0):
        b.set_times(t0, 4.0)
        for c in range(2):
            b.trace_tile("filtered", c)
            b.spec_tile(c, quantize=True)

    def pulled(fn):
        tr.enable(log=False)
        tr.clear()
        try:
            fn()
            return sum(e["bytes"] for e in tr.events("render.pull")
                       if "tile" in e["op"])
        finally:
            tr.disable()

    view(0.0)  # settle programs and caches
    full = pulled(lambda: view(10.0))     # jump: no overlap, full pull
    assert full > 0
    delta = pulled(lambda: view(12.0))    # half-window scroll
    assert delta < 0.6 * full, (delta, full)
    # param change invalidates content: the next pull is full again
    b.update_filter(highpass_cutoff=500.0)
    redo = pulled(lambda: view(12.0))
    assert redo > 0.9 * full, (redo, full)

    # assembled delta tiles == a fresh tiler's full pull
    ft = b.data["filtered"]
    tt = TraceTiler()
    times_a, vals_a = b.trace_tiler.tile(ft, 12.0, 16.0)
    times_b, vals_b = tt.tile(ft, 12.0, 16.0)
    np.testing.assert_array_equal(times_a, times_b)
    np.testing.assert_allclose(vals_a, vals_b, atol=2e-4)
    st = SpecTiler()
    lv = np.array([b.estimate_power_levels(c) for c in range(2)],
                  np.float32)
    spec = b.data[b.spectrogram]
    img_a, rect_a = b.spec_tiler.tile(spec, 0, None, None, quantize=True,
                                      t0=12.0, t1=16.0, levels=lv)
    img_b, rect_b = st.tile(spec, 0, None, None, quantize=True,
                            t0=12.0, t1=16.0, levels=lv)
    assert rect_a == rect_b
    np.testing.assert_array_equal(img_a, img_b)
    b.close()


def test_save_region_flac_target_from_u8_source(tmp_path, rng):
    """A WAV-only encoding (PCM_U8) must not leak into a .flac region
    export — the encoding validates against the TARGET format's list —
    and the CodingHistory line describes the WRITTEN file (post-remap
    encoding, selected channel count), not the source."""
    rate = 8000.0
    x = np.clip(0.4 * rng.standard_normal((8000, 4)), -1, 0.99)
    p = tmp_path / "u8.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_U8")
    b = DataBrowser(p, buffer_time=0.5).open()
    b.select_channels([0, 1])
    out = b.save_region(0.2, 0.6, tmp_path / "cut.flac")
    data, r2, md, _locs, _labels = wavio.load_wav(out)
    assert r2 == rate and data.shape == (int(0.4 * rate), 2)
    hist = md.get("CodingHistory") or md.get("BEXT", {}).get(
        "CodingHistory", "")
    assert "W=16" in hist and "M=stereo" in hist.splitlines()[-1]
    b.close()
