"""Headless Data API tests (SURVEY.md section 4 item 5): the model layer
drives the whole pipeline without any GUI, matching the reference ``Data``
semantics (`src/audian/data.py`)."""

import numpy as np
import pytest
import scipy.signal as sps

from audian_tpu.data import Data, AudioLoader, default_traces, wavio
from audian_tpu.graph import SpectrogramNode, FilterNode, MissingSourceError, EnvelopeNode


RATE = 44100.0


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory, cricket_like):
    x, rate = cricket_like
    p = tmp_path_factory.mktemp("data") / "cricket.wav"
    md = {"BEXT": {"OriginationDate": "2026-03-04",
                   "OriginationTime": "10:00:00"}}
    locs = np.array([[1000, 0], [40000, 2000]])
    labels = np.array([["start", ""], ["song", "chirp"]], dtype=object)
    wavio.write_audio(p, x, rate, metadata=md, locs=locs, labels=labels,
                      encoding="FLOAT")
    return p


@pytest.fixture(scope="module")
def multi_files(tmp_path_factory, cricket_like):
    x, rate = cricket_like
    d = tmp_path_factory.mktemp("multi")
    n = len(x) // 3
    paths = []
    for k in range(3):
        p = d / f"part{k}.wav"
        wavio.write_audio(p, x[k * n : (k + 1) * n], rate, encoding="FLOAT")
        paths.append(p)
    return paths, x[: 3 * n], rate


def open_data(wav_file, **kwargs):
    d = Data(wav_file, **kwargs)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    return d


def test_loader_basics(wav_file, cricket_like):
    x, rate = cricket_like
    ld = AudioLoader(wav_file)
    assert ld.rate == rate
    assert ld.channels == 2
    assert ld.frames == len(x)
    np.testing.assert_allclose(ld[100:200], x[100:200], atol=1e-7)
    np.testing.assert_allclose(ld[100:200, 1], x[100:200, 1], atol=1e-7)
    np.testing.assert_allclose(ld[5, 0], x[5, 0], atol=1e-7)


def test_loader_window_management(wav_file):
    ld = AudioLoader(wav_file, buffer_time=0.5, back_time=0.1)
    ld.update_time(1.0, 1.2)
    assert ld.offset <= int(0.9 * ld.rate)
    assert ld.offset + len(ld.buffer) >= int(1.2 * ld.rate)
    # in-buffer access does not move the window
    off = ld.offset
    _ = ld[int(1.05 * ld.rate) : int(1.1 * ld.rate)]
    assert ld.offset == off
    # out-of-buffer access reads through without moving it
    head = ld[0:10]
    assert ld.offset == off and head.shape == (10, 2)


def test_multi_file_concatenation(multi_files):
    paths, x, rate = multi_files
    ld = AudioLoader(paths)
    assert ld.frames == len(x)
    np.testing.assert_allclose(ld[0 : len(x) : 1000], x[::1000], atol=1e-7)
    # straddle a file boundary
    b = int(ld.end_indices[0])
    np.testing.assert_allclose(ld[b - 5 : b + 5], x[b - 5 : b + 5], atol=1e-7)
    fp, local = ld.get_file_index(b + 3)
    assert fp == paths[1] and local == 3


def test_data_open_and_registry(wav_file):
    d = open_data(wav_file)
    assert d.rate == RATE and d.channels == 2
    assert set(d.keys()) == {"data", "filtered", "envelope", "spectrogram"}
    assert d["FILTERED"] is d["filtered"]
    assert "envelope" in d and "nope" not in d
    assert len(d) == 4
    assert d.start_time is not None and d.start_time.hour == 10
    assert d.meta_data["Format"]["format"] == "WAV"
    assert d.get_trace_names(SpectrogramNode) == ["spectrogram"]
    d.remove_trace("envelope")
    assert "envelope" not in d
    d.close()


def test_data_missing_source(wav_file):
    d = Data(wav_file)
    d.add_trace(EnvelopeNode("envelope", "missing"))
    with pytest.raises(MissingSourceError):
        d.open()


def test_update_times_computes_visible(wav_file, cricket_like):
    x, rate = cricket_like
    d = open_data(wav_file)
    d["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    name = d.update_times(0.5, 1.0)
    assert name == "cricket.wav"
    f = d["filtered"]
    i0, i1 = int(0.5 * rate), int(1.0 * rate)
    got = f[i0:i1]
    sos = f.design.sos
    want = sps.sosfilt(sos, x.astype(np.float32), axis=0)[i0:i1]
    np.testing.assert_allclose(got, want, atol=2e-5)
    # spectrogram window present and aligned
    s = d["spectrogram"]
    assert s.offset <= int(0.5 * s.rate)
    assert s.buffer.shape[1:] == (2, 129)
    d.close()


def test_trace_on_demand_range(wav_file, cricket_like):
    """Random access outside the buffered window computes on demand."""
    x, rate = cricket_like
    d = open_data(wav_file)
    d.update_times(0.0, 0.2)
    env = d["envelope"]
    seg = env[60000:60500]  # ~1.4 s, outside the window
    esos = env.design.sos
    base = sps.sosfilt(d["filtered"].design.sos if d["filtered"].design else None,
                       x, axis=0) if d["filtered"].design else x
    want = sps.sosfiltfilt(esos, (np.pi / 2) * np.abs(base), axis=0)
    want[want < 0] = 0
    np.testing.assert_allclose(seg, want[60000:60500], atol=2e-5)
    d.close()


def test_get_region_shapes(wav_file):
    d = open_data(wav_file)
    d.update_times(0.0, 0.5)
    region = d.get_region(0.1, 0.2, channel=0)
    t, y = region["filtered"]
    assert len(t) == len(y) == int(0.2 * RATE) + 1 - int(0.1 * RATE)
    ts, fs, sxx = region["spectrogram"]
    assert len(fs) == 129
    assert sxx.shape == (len(ts), 129)
    d.close()


def test_laziness_gate(wav_file):
    d = open_data(wav_file)
    d.set_visible("spectrogram", False)
    d.set_visible("envelope", False)
    d.update_times(0.2, 0.4)
    assert len(d["filtered"].buffer) > 0
    assert len(d["spectrogram"].buffer) == 0  # never computed
    d.close()


def test_param_update_refreshes_window(wav_file, cricket_like):
    x, rate = cricket_like
    d = open_data(wav_file)
    d.update_times(0.5, 1.0)
    d["filtered"].update(highpass_cutoff=3000.0, lowpass_cutoff=9000.0)
    f = d["filtered"]
    i0 = int(0.6 * rate)
    want = sps.sosfilt(f.design.sos, x.astype(np.float32), axis=0)
    np.testing.assert_allclose(f[i0 : i0 + 100], want[i0 : i0 + 100],
                               atol=2e-5)
    # NFFT change propagates geometry
    d["spectrogram"].update(nfft=512)
    s = d["spectrogram"]
    assert s.spec.more_shape == (257,)
    assert s.frequencies.shape == (257,)
    d.close()


def test_unwrap_path(tmp_path):
    # unwrap detection requires the true per-sample slope to stay below the
    # threshold, so use a slow signal that overdrives the ADC range
    rate = 44100.0
    t = np.arange(int(rate)) / rate
    x = 0.9 * np.sin(2 * np.pi * 4.0 * t)[:, None]
    wrapped = np.where(np.abs(2 * x) > 1.0, 2 * x - np.sign(x) * 2.0, 2 * x)
    p = tmp_path / "w.wav"
    wavio.write_audio(p, wrapped, rate, encoding="FLOAT")
    d = Data(p)
    d.open(unwrap=1.5)
    got = d["data"][0 : len(x)]
    np.testing.assert_allclose(got, x, atol=1e-4)
    d.close()


def test_reference_update_idiom(wav_file, cricket_like):
    """The reference mutates node attributes then calls update() with no
    arguments (`src/audian/databrowser.py:1271-1283`); attribute writes
    must reach the node through the Trace view."""
    import scipy.signal as sps

    x, rate = cricket_like
    d = open_data(wav_file)
    d.update_times(0.3, 0.6)
    f = d["filtered"]
    f.highpass_cutoff = 2500.0
    f.lowpass_cutoff = 9000.0
    f.update()
    assert f._node.highpass_cutoff == 2500.0
    assert f.design.sos.shape == (2, 6)
    i0 = int(0.4 * rate)
    want = sps.sosfilt(f.design.sos, x.astype(np.float32), axis=0)
    np.testing.assert_allclose(f[i0 : i0 + 200], want[i0 : i0 + 200],
                               atol=2e-5)
    env = d["envelope"]
    env.envelope_cutoff = 125.0
    env.update()
    assert env._node.envelope_cutoff == 125.0
    d.close()


def test_incremental_scroll_matches_full_recompute(tmp_path, rng):
    """Scrolling slides the device windows and recomputes only the new
    sub-window (`Data._try_delta_update`); the stitched trace windows
    must match a from-scratch recompute of the same window."""
    rate = 8000.0
    x = (0.3 * np.sin(2 * np.pi * 440.0 *
                      np.arange(int(20.0 * rate)) / rate)
         + 0.02 * rng.standard_normal(int(20.0 * rate)))
    x = np.stack([x, 0.5 * x], axis=1)
    p = tmp_path / "r.wav"
    wavio.write_audio(p, x, rate, encoding="FLOAT")
    d = Data(p, buffer_time=6.0, back_time=2.0)
    for node in default_traces():
        d.add_trace(node)
    d.setup_traces()
    d.open()
    d["filtered"].update(highpass_cutoff=100.0)
    d.update_times(0.0, 2.0)
    deltas = 0
    orig = d._try_delta_update

    def counting(dev, targets):
        nonlocal deltas
        hit = orig(dev, targets)
        deltas += bool(hit and d._last_raw_shift)
        return hit

    d._try_delta_update = counting
    for k in range(1, 8):
        d.update_times(1.5 * k, 1.5 * k + 3.0)
    assert deltas >= 3, "scrolls did not take the incremental path"
    # snapshot stitched windows, then force a full recompute and compare
    stitched = {name: (d[name].offset, np.asarray(d[name].buffer))
                for name in ("filtered", "envelope", "spectrogram")}
    d._dev_raw = None  # invalidate -> full upload + full recompute
    d._try_delta_update = lambda dev, targets: False
    d.update_times(10.5, 13.5)
    for name, (off, arr) in stitched.items():
        assert d[name].offset == off
        np.testing.assert_allclose(arr, np.asarray(d[name].buffer),
                                   atol=2e-6)
    # scroll backwards through the retained back buffer
    d._try_delta_update = counting
    d.update_times(9.0, 12.0)
    full = np.asarray(d["filtered"].buffer)
    d._dev_raw = None
    d._try_delta_update = lambda dev, targets: False
    d.update_times(9.0, 12.0)
    np.testing.assert_allclose(full, np.asarray(d["filtered"].buffer),
                               atol=2e-6)
    d.close()


def test_pcm16_device_upload_exact(tmp_path, rng):
    """PCM-16 sources upload as int16 and dequantize on device — the
    device raw mirror must equal the host decode bit-for-bit, with
    sliding updates taking the same quantized path."""
    rate = 8000.0
    x = np.clip(0.4 * rng.standard_normal((int(20.0 * rate), 2)), -1, 0.99)
    p = tmp_path / "p16.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    d = Data(p, buffer_time=6.0, back_time=2.0)
    for node in default_traces():
        d.add_trace(node)
    d.setup_traces()
    d.open()
    d.update_times(0.0, 2.0)
    dev = d._device_raw()
    host = d.data.buffer
    assert np.array_equal(np.asarray(dev), host.astype(np.float32))
    # the upload staged through the raw16 direct-read path (no f32
    # quantize passes), not just the quantize fallback
    assert d.data.raw16_capable and len(d._q_staging) > 0
    # slide and re-check bit-exactness of the stitched device window
    for k in range(1, 5):
        d.update_times(1.5 * k, 1.5 * k + 3.0)
    dev = d._device_raw()
    host = d.data.buffer
    assert np.array_equal(np.asarray(dev), host.astype(np.float32))
    d.close()


def test_hidden_trace_not_stale_after_param_update(tmp_path, rng):
    """Parameter updates while a trace is hidden must not let the scroll
    fast path serve its stale window once it is shown again."""
    rate = 8000.0
    x = rng.standard_normal((int(20.0 * rate), 1))
    p = tmp_path / "st.wav"
    wavio.write_audio(p, x, rate, encoding="FLOAT")
    d = Data(p, buffer_time=6.0, back_time=2.0)
    for node in default_traces():
        d.add_trace(node)
    d.setup_traces()
    d.open()
    d["filtered"].update(highpass_cutoff=100.0)
    d.update_times(0.0, 2.0)
    env0 = np.asarray(d["envelope"].buffer).copy()
    # hide the envelope, change the filter, recompute
    d.set_visible("envelope", False)
    d["filtered"].update(highpass_cutoff=1500.0)
    d.update_times(0.0, 2.0)
    # re-show: the same window must produce FRESH envelope data
    d.set_visible("envelope", True)
    d.update_times(0.0, 2.0)
    env1 = np.asarray(d["envelope"].buffer)
    assert env1.shape == env0.shape
    assert not np.allclose(env1, env0), "stale hidden-trace buffer served"
    # and it matches a from-scratch recompute
    d._dev_raw = None
    d._try_delta_update = lambda dev, targets: False
    d.update_times(0.0, 2.0)
    np.testing.assert_allclose(env1, np.asarray(d["envelope"].buffer),
                               atol=2e-6)
    d.close()


def test_add_trace_preserves_filter_params(wav_file, cricket_like):
    from audian_tpu.graph import EnvelopeNode

    d = open_data(wav_file)
    d["filtered"].update(highpass_cutoff=1234.0, lowpass_cutoff=9000.0)
    d.add_trace(EnvelopeNode("envelope2", "filtered"))
    assert d["filtered"].highpass_cutoff == 1234.0
    assert d["filtered"].lowpass_cutoff == 9000.0
    assert d["filtered"].design is not None
    d.close()


def test_reversed_slice(wav_file):
    d = open_data(wav_file)
    d.update_times(0.1, 0.3)
    fwd = np.asarray(d["filtered"][1000:1200])
    rev = np.asarray(d["filtered"][1199:999:-1])
    np.testing.assert_array_equal(rev, fwd[::-1])
    rev2 = np.asarray(d["filtered"][1199:999:-2])
    np.testing.assert_array_equal(rev2, fwd[::-1][::2])
    d.close()


def test_unwrap_chunk_boundary_consistent(tmp_path):
    """A wrap jump exactly AT a chunk boundary must be detected — the
    read seeds the diff with one sample of left context.  (Wraps still
    open from before the window keep the reference's per-buffer
    semantics.)"""
    rate = 1000.0
    t = np.arange(2000) / rate
    clean = 1.4 * np.sin(2 * np.pi * 5.0 * t)
    wrapped = np.mod(clean + 1.0, 2.0) - 1.0
    p = tmp_path / "wrap.wav"
    wavio.write_audio(p, wrapped[:, None], rate, encoding="FLOAT")
    from audian_tpu.data.loader import AudioLoader

    ld = AudioLoader(p)
    ld.set_unwrap(1.5, clips=False)
    whole = ld._read_direct(0, 2000)
    # start a read exactly at the first wrapped sample: the jump happens
    # between start-1 and start, invisible without the context sample
    jumps = np.nonzero(np.diff(wrapped) < -1.5)[0]
    s0 = int(jumps[0]) + 1
    part = ld._read_direct(s0, 200)
    np.testing.assert_allclose(part[:, 0], whole[s0 : s0 + 200, 0],
                               atol=1e-6)
    ld.close()


def test_scrub_does_not_reopen_graph(wav_file, cricket_like):
    """Cutoff scrubs must not re-open the whole graph (only geometry
    changes like NFFT respecs do)."""
    d = open_data(wav_file)
    d.update_times(0.1, 0.3)
    calls = []
    orig = d.graph.open
    d.graph.open = lambda spec: (calls.append(1), orig(spec))[1]
    d["filtered"].update(highpass_cutoff=1500.0)
    d["envelope"].update(envelope_cutoff=300.0)
    assert not calls, "parameter scrub re-opened the graph"
    d["spectrogram"].update(nfft=512)
    assert calls, "NFFT respec must re-open downstream specs"
    d.close()


def test_empty_reversed_slice_no_compute(wav_file):
    d = open_data(wav_file)
    d.update_times(0.5, 0.7)
    calls = []
    orig = d._compute_range
    d._compute_range = lambda *a, **k: (calls.append(a), orig(*a, **k))[1]
    out = d["filtered"][600:700:-1]
    assert out.shape[0] == 0
    assert not calls, "empty slice hit the compute path"
    d.close()


def test_mixed_encoding_multifile_upload_exact(tmp_path, rng):
    """A multi-file recording mixing PCM-16 and FLOAT files must NOT use
    the int16 upload (quantizing the float file's samples)."""
    rate = 8000.0
    x = (0.3 * rng.standard_normal((int(4.0 * rate), 1))).clip(-1, 0.99)
    p1 = tmp_path / "a.wav"
    p2 = tmp_path / "b.wav"
    n = len(x) // 2
    wavio.write_audio(p1, x[:n], rate, encoding="PCM_16")
    wavio.write_audio(p2, x[n:], rate, encoding="FLOAT")
    d = Data([p1, p2], buffer_time=2.0, back_time=0.5)
    for node in default_traces():
        d.add_trace(node)
    d.setup_traces()
    d.open()
    d.update_times(1.8, 2.2)  # spans the file boundary
    dev = np.asarray(d._device_raw())
    host = d.data.buffer.astype(np.float32)
    assert np.array_equal(dev, host)
    d.close()


def test_file_start_times_feed_per_file_axis(tmp_path, rng):
    """AudioLoader.file_start_times + FILE_TIME ticks label per-file
    times (`timeaxisitem.py:20-26`; review finding: the method was
    missing so the mode silently fell back to recording time)."""
    from audian_tpu.data.loader import AudioLoader
    from audian_tpu.view.axes import format_time_ticks, FILE_TIME

    rate = 8000.0
    paths = []
    for k in range(2):
        x = 0.1 * rng.standard_normal((int(1.5 * rate), 1))
        p = tmp_path / f"part{k}.wav"
        wavio.write_audio(p, x, rate, encoding="PCM_16")
        paths.append(p)
    ld = AudioLoader(paths)
    starts = ld.file_start_times()
    np.testing.assert_allclose(starts, [0.0, 1.5])
    label, units, strings, filename = format_time_ticks(
        [2.0, 2.5], 0.5, mode=FILE_TIME, file_times=starts,
        file_paths=[p.name for p in paths])
    assert label == "File"
    assert filename == "part1.wav"
    # 2.0 s global = 0.5 s into the second file
    assert strings[0].startswith("0.5") or strings[0] == "0.500"
    ld.close()


def test_hidden_update_never_serves_stale_reads(wav_file):
    """A parameter update on a hidden trace marks it dirty; reads must
    compute fresh values, and showing it again must refresh the window
    before the GUI reads .buffer."""
    d = Data(wav_file)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d.update_times(0.2, 0.6)
    env = d["envelope"]
    before = np.array(env[12000:12400, 0])
    d.set_visible("envelope", False)
    env.update(envelope_cutoff=env.envelope_cutoff * 4)
    after_hidden = np.array(env[12000:12400, 0])
    assert not np.allclose(before, after_hidden)   # not the stale buffer
    # showing the trace refreshes its device window
    d.set_visible("envelope", True)
    assert "envelope" not in d._dirty
    inwin = np.array(env[12000:12400, 0])
    np.testing.assert_allclose(inwin, after_hidden, atol=1e-5)
    d.close()


def test_hidden_dirty_trace_reads_refresh_the_window_once(wav_file):
    """Reading a hidden-but-dirty trace refreshes its device window ONCE
    and serves later reads from it — per-access fresh computes would run
    one device program (raw read + upload + chain + pull) per
    ``__getitem__``."""
    d = Data(wav_file)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d.update_times(0.2, 0.6)
    env = d["envelope"]
    d.set_visible("envelope", False)
    env.update(envelope_cutoff=env.envelope_cutoff * 4)
    assert "envelope" in d._dirty
    calls = []
    orig = d.executor.run

    def counting_run(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    d.executor.run = counting_run
    try:
        first = np.array(env[12000:12400, 0])
        assert "envelope" not in d._dirty
        n_first = len(calls)
        assert n_first >= 1
        again = np.array(env[12000:12400, 0])
        shifted = np.array(env[12100:12300, 0])
        assert len(calls) == n_first  # in-window reads: no new programs
    finally:
        d.executor.run = orig
    np.testing.assert_allclose(again, first, atol=1e-6)
    np.testing.assert_allclose(shifted, first[100:300], atol=1e-6)
    # the refreshed window holds the post-update values
    d.set_visible("envelope", True)
    np.testing.assert_allclose(np.array(env[12000:12400, 0]), first,
                               atol=1e-5)
    d.close()


def test_reopen_resets_trace_windows(wav_file):
    """Re-opening a Data must not serve the previous open's buffers —
    decode semantics (unwrap) or even the file can change."""
    d = Data(wav_file)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d.update_times(0.2, 0.6)
    assert len(d["filtered"].buffer) > 0
    d.open()  # reopen: windows reset, nothing served from the last open
    assert len(d["filtered"].buffer) == 0
    assert d["filtered"].offset == 0
    d.update_times(0.2, 0.6)
    assert len(d["filtered"].buffer) > 0
    d.close()


def test_update_after_close_is_noop(wav_file):
    d = Data(wav_file)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d.update_times(0.2, 0.4)
    d.close()
    d["filtered"].update(highpass_cutoff=500.0)  # must not crash


def test_delta_update_requires_all_traces_produced(wav_file, monkeypatch):
    """If the scroll sub-window produces no output for some tracked
    trace (huge NFFT vs a small scroll), the fast path must fall back to
    the full recompute instead of freezing that trace's window."""
    from audian_tpu.graph.executor import GraphExecutor

    rate = 44100.0
    t = np.arange(int(4.0 * rate)) / rate
    x = np.stack([0.6 * np.sin(2 * np.pi * 4800 * t),
                  0.3 * np.sin(2 * np.pi * 900 * t)], axis=1)
    p = wav_file.parent / "delta4s.wav"
    wavio.write_audio(p, x.astype(np.float32), rate, encoding="FLOAT")
    # buffer_time=1.0: the scroll sub-window (pow2ceil(shift + halo
    # fold)) fits inside the raw window, so the delta fast path applies
    d = Data(p, buffer_time=1.0, back_time=0.05)
    for node in default_traces():
        d.add_trace(node)
    d.open()
    d.update_times(0.0, 0.2)
    cap = len(d.data.buffer)
    real_run = GraphExecutor.run

    def dropping_run(self, raw, raw_offset=0, targets=None, device=True):
        out = real_run(self, raw, raw_offset=raw_offset, targets=targets,
                       device=device)
        if len(raw) < cap:  # the scroll sub-window run
            out = {k: v for k, v in out.items() if k != "spectrogram"}
        return out

    monkeypatch.setattr(GraphExecutor, "run", dropping_run)
    # scroll forward: window moves exercise the delta path every step
    for k in range(1, 14):
        d.update_times(0.2 * k, 0.2 * k + 0.2)
        g_off = d["spectrogram"].offset
        # the window must always track the executor's full plan — a
        # frozen (stale) offset means the fast path claimed success
        # without producing spectrogram output
        active = d.graph.active_set(
            [n for n in d.visible_traces() if n != "data"])
        plan, _ = d.executor._plan(int(d.data.offset),
                                   len(d.data.buffer), active)
        assert g_off == plan["spectrogram"].o0, f"stale at step {k}"
    d.close()


def test_loader_negative_step_slices(wav_file, cricket_like):
    """Reversed slices must serve correct data from both the buffered
    and the disk path (the forward formulas returned empty arrays)."""
    x, rate = cricket_like
    ld = AudioLoader(wav_file, buffer_time=0.05, back_time=0.0)
    ld.update_time(0.0, 0.04)  # buffer holds an initial window
    # buffered, reaching frame 0 (stop=-1 would go end-relative in numpy)
    np.testing.assert_allclose(ld[5::-1], x[5::-1], atol=1e-7)
    # outside the buffer: the disk path
    n = ld.frames
    np.testing.assert_allclose(ld[n - 1 : n - 51 : -1],
                               x[n - 1 : n - 51 : -1], atol=1e-7)
    np.testing.assert_allclose(ld[n - 1 : n - 51 : -2],
                               x[n - 1 : n - 51 : -2], atol=1e-7)
    ld.close()


def test_loader_zero_buffer_time_does_not_hang(wav_file):
    """buffer_time*rate < 1 gave bufferframes 0 and an infinite
    n *= 2 loop in update_time."""
    ld = AudioLoader(wav_file, buffer_time=0.0, back_time=0.0)
    ld.update_time(0.0, 0.01)
    assert len(ld.buffer) > 0
    ld.close()


def test_wav_data_chunk_before_fmt_raises_waverror(tmp_path):
    """A reordered RIFF (data before fmt) must raise WavError from
    load_wav, not leak a TypeError."""
    import struct

    payload = b"data" + struct.pack("<I", 4) + b"\0\0\0\0"
    payload += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 16000,
                                     2, 16)
    riff = b"RIFF" + struct.pack("<I", 4 + len(payload)) + b"WAVE" + payload
    p = tmp_path / "reordered.wav"
    p.write_bytes(riff)
    with pytest.raises(wavio.WavError):
        wavio.load_wav(p)


def test_flac16_device_upload_uses_raw16_path(tmp_path, rng):
    """16-bit FLAC sources take the same int16 upload fast path as
    PCM-16 WAV (half the upload bytes): the gate used to demand
    all-PCM_16-WAV and silently fall back to f32 uploads for FLAC."""
    rate = 8000.0
    x = np.clip(0.4 * rng.standard_normal((int(20.0 * rate), 2)), -1, 0.99)
    p = tmp_path / "p16.flac"
    wavio.write_audio(p, x, rate, format="FLAC", encoding="PCM_16")
    d = Data(p, buffer_time=6.0, back_time=2.0)
    for node in default_traces():
        d.add_trace(node)
    d.setup_traces()
    d.open()
    d.update_times(0.0, 2.0)
    dev = d._device_raw()
    host = d.data.buffer
    assert np.array_equal(np.asarray(dev), host.astype(np.float32))
    assert d.data.raw16_capable and len(d._q_staging) > 0, \
        "FLAC_16 upload did not stage through the raw16 path"
    for k in range(1, 4):
        d.update_times(1.5 * k, 1.5 * k + 3.0)
    dev = d._device_raw()
    assert np.array_equal(np.asarray(dev),
                          d.data.buffer.astype(np.float32))
    d.close()
