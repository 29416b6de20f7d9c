"""Device-loss resilience: the watchdog, the host scipy fallback, and
mid-session outage recovery.

A device can stop answering in two ways: backend init hangs, or — worse
— ``jax.devices()`` answers but every op hangs.  The
reference can never hang on a device because its hot loop is pure host
scipy (`/root/reference/src/audian/databrowser.py:1126-1314`); these
tests pin the same property for the device-first session: an injected
mid-session outage never hangs a verb, pixels come from the host scipy
path, and the session recovers automatically when the device returns.
"""

import threading
import time

import numpy as np
import pytest
import scipy.signal

from audian_tpu.app import DataBrowser
from audian_tpu.analysis import Plugins
from audian_tpu.data import wavio
from audian_tpu.graph import EnvelopeNode
from audian_tpu.utils.devicewatch import DeviceLost, DeviceWatch, watch


@pytest.fixture()
def fast_watch(monkeypatch):
    """The process singleton with test-sized timeouts, restored after."""
    monkeypatch.setattr(watch, "patience", 0.05)
    monkeypatch.setattr(watch, "heartbeat_timeout", 0.2)
    monkeypatch.setattr(watch, "first_heartbeat_timeout", 0.2)
    monkeypatch.setattr(watch, "reprobe_interval", 0.05)
    yield watch
    watch._lost = False
    watch._listeners.clear()
    watch._pending_probe = None


# -- unit: the watchdog ------------------------------------------------------


def test_pull_fast_thunk_passes_through(fast_watch):
    assert fast_watch.pull(lambda: 41 + 1) == 42


def test_pull_propagates_thunk_errors(fast_watch):
    with pytest.raises(ZeroDivisionError):
        fast_watch.pull(lambda: 1 // 0)


def test_pull_slow_but_alive_device_waits(fast_watch, monkeypatch):
    """Heartbeats answering -> a slow pull (a long compile) is NOT a
    loss; the watchdog keeps waiting."""
    monkeypatch.setattr(fast_watch, "_probe", lambda: True)

    def slow():
        time.sleep(0.4)  # >> patience
        return "done"

    assert fast_watch.pull(slow) == "done"
    assert not fast_watch.lost


def test_pull_hung_thunk_dead_heartbeat_raises(fast_watch, monkeypatch):
    """A hung transfer plus a hung/dead heartbeat marks the device lost
    within the watchdog deadlines instead of blocking forever."""
    monkeypatch.setattr(fast_watch, "_probe", lambda: time.sleep(60))
    release = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(DeviceLost):
        fast_watch.pull(lambda: release.wait(30))
    took = time.monotonic() - t0
    release.set()
    assert took < 5.0, f"watchdog took {took:.1f}s"
    assert fast_watch.lost
    # once lost, further pulls fail fast without running the thunk
    t0 = time.monotonic()
    with pytest.raises(DeviceLost):
        fast_watch.pull(lambda: release.wait(30))
    assert time.monotonic() - t0 < 0.5


def test_hung_probe_does_not_stack_threads(fast_watch, monkeypatch):
    """Only ONE probe op is ever in flight: while a probe is blocked
    inside the hung runtime, later liveness checks wait on IT instead of
    spawning fresh threads — a 10+ h outage (observed) would otherwise
    leak a thread (each holding a queued device op, all replayed at
    recovery) per reprobe cycle."""
    started = []
    blocker = threading.Event()

    def hung_probe():
        started.append(1)
        blocker.wait(30)
        return True

    monkeypatch.setattr(fast_watch, "_probe", hung_probe)
    for _ in range(5):
        assert not fast_watch._probe_alive(timeout=0.05)
    assert len(started) == 1, f"{len(started)} probe threads spawned"
    blocker.set()


def test_blocked_probe_completion_counts_as_recovery(monkeypatch):
    """When the device answers again, the single long-blocked probe finally
    answers — and that answer must flip the state back (the reprobe loop
    waits on the pending probe rather than racing a new one)."""
    blocker = threading.Event()
    w = DeviceWatch(probe=lambda: blocker.wait(30))
    w.patience = 0.05
    w.heartbeat_timeout = 0.1
    w.first_heartbeat_timeout = 0.1
    w.reprobe_interval = 0.05
    w.mark_lost("test")
    time.sleep(0.4)  # several reprobe cycles against the blocked probe
    assert w.lost
    blocker.set()  # device revives: the one in-flight probe answers True
    for _ in range(100):
        if not w.lost:
            break
        time.sleep(0.02)
    assert not w.lost, "blocked probe's answer did not recover the state"


def test_reprobe_recovers_and_notifies(monkeypatch):
    w = DeviceWatch(probe=lambda: probe_ok[0])
    w.patience = 0.05
    w.heartbeat_timeout = 0.2
    w.first_heartbeat_timeout = 0.2
    w.reprobe_interval = 0.05
    probe_ok = [False]
    flips = []
    w.add_listener(flips.append)
    w.mark_lost("test")
    assert w.lost and flips == [True]
    probe_ok[0] = True
    for _ in range(100):
        if not w.lost:
            break
        time.sleep(0.05)
    assert not w.lost, "background reprobe did not recover"
    assert flips == [True, False]


# -- integration: mid-session outage in the browser --------------------------


@pytest.fixture()
def outage_browser(tmp_path, rng):
    rate = 8000.0
    # long enough that the 2 s loader window MUST slide on a jump —
    # otherwise every scroll is served from the resident window and the
    # injected outage is never exercised
    t = np.arange(int(30 * rate)) / rate
    x = (0.4 * np.sin(2 * np.pi * 440 * t)[:, None]
         * np.ones((1, 2))).astype(np.float32)
    x += 0.01 * rng.standard_normal(x.shape).astype(np.float32)
    p = tmp_path / "rec.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    plugins = Plugins()
    plugins.add_trace_factory(
        lambda b: b.add_trace(EnvelopeNode("envelope", "filtered")))
    b = DataBrowser(p, plugins=plugins, buffer_time=2.0,
                    back_time=0.5).open()
    yield b
    b.close()
    watch._lost = False
    watch._pending_probe = None


def _host_oracle_filtered(browser, t0, t1):
    """scipy float64 oracle of the filtered trace over [t0, t1]."""
    node = browser.data["filtered"]._node
    ld = browser.data.data
    raw = np.asarray(ld[0 : ld.frames]).astype(np.float64)
    if node._sos is None:  # default design: pass-through
        y = raw
    else:
        y = scipy.signal.sosfilt(node._sos, raw, axis=0)
    rate = browser.data.rate
    return y[int(t0 * rate) : int(t1 * rate)]


def test_outage_mid_session_serves_host_pixels(outage_browser, monkeypatch):
    """Device dies mid-session: no verb hangs, windows flip to numpy
    (host scipy), tiles carry correct host values, and the browser
    reports "device lost — host mode"."""
    b = outage_browser
    b.set_times(0.0, 1.0)
    t_dev, v_dev = b.trace_tile("filtered", 0)
    assert len(v_dev)

    # inject the outage: every guarded device section now hangs, and
    # heartbeats fail -> the watchdog must declare the device lost
    monkeypatch.setattr(watch, "patience", 0.05)
    monkeypatch.setattr(watch, "heartbeat_timeout", 0.1)
    monkeypatch.setattr(watch, "first_heartbeat_timeout", 0.1)
    monkeypatch.setattr(watch, "_probe", lambda: time.sleep(60))
    release = threading.Event()
    real_run = b.data.executor.run

    def hung_run(*a, **k):
        release.wait(30)
        raise RuntimeError("device gone")

    monkeypatch.setattr(b.data.executor, "run", hung_run)

    t0 = time.monotonic()
    # jump to an unloaded region so the update cannot be served from
    # the delta cache — the hung executor MUST be hit
    b.set_times(20.0, 1.0)
    took = time.monotonic() - t0
    assert took < 10.0, f"scroll hung for {took:.1f}s"
    release.set()
    assert watch.lost
    assert b.device_state == "lost"
    assert b.device_status_text() == "device lost — host mode"

    # windows are host numpy now; tiles render without the device and
    # match the scipy float64 oracle
    filt = b.data["filtered"]
    assert isinstance(filt.buffer, np.ndarray)
    times, values = b.trace_tile("filtered", 0)
    assert len(values) and np.all(np.isfinite(values))
    oracle = _host_oracle_filtered(b, 20.0, 21.0)
    # min/max tiles sample extrema of oracle segments; just bound them
    assert np.max(np.abs(values)) <= np.max(np.abs(oracle)) + 1e-4
    # envelope + spectrogram panels render host-side too
    et, ev = b.trace_tile("envelope", 0)
    assert len(ev) and np.all(ev >= -1e-4)
    img, rect = b.spec_tile(0, quantize=True)
    assert img.size and img.dtype == np.uint8

    # every further verb stays live (host mode short-circuits the device)
    b.time_page_down()
    b.update_filter(highpass_cutoff=100.0)
    t2, v2 = b.trace_tile("filtered", 0)
    assert len(v2)

    # -- recovery: the fake device comes back -------------------------------
    monkeypatch.setattr(b.data.executor, "run", real_run)
    monkeypatch.setattr(watch, "_probe", lambda: True)
    watch.mark_ok()  # what the background reprobe does on success
    assert b.poll_device_state() == "ok"
    filt = b.data["filtered"]
    assert not isinstance(filt.buffer, np.ndarray), \
        "recovery must recompute windows on the device"
    t3, v3 = b.trace_tile("filtered", 0)
    assert len(v3) and np.all(np.isfinite(v3))


def test_host_mode_matches_device_values(outage_browser):
    """Host-mode trace windows agree with the device-computed windows at
    the kernel accuracy contract (1e-5) — the pixels a user sees during
    an outage are the same signal."""
    b = outage_browser
    b.set_times(0.5, 1.5)
    dev_tiles = {}
    for name in ("filtered", "envelope"):
        dev_tiles[name] = b.trace_tile(name, 0)
    img_d, rect_d = b.spec_tile(0, zmin=-100.0, zmax=-20.0,
                                quantize=True)
    # flip to host mode directly (as the watchdog would)
    b.data._host_windows()
    for name in ("filtered", "envelope"):
        tr = b.data[name]
        assert isinstance(tr.buffer, np.ndarray)
        t_h, v_h = b.trace_tile(name, 0)
        t_d, v_d = dev_tiles[name]
        assert len(v_h) == len(v_d)
        np.testing.assert_allclose(v_h, v_d, atol=1e-4)
    # spectrogram host tile matches the device tile bit-nearly at
    # FIXED levels (auto-leveling percentiles may differ marginally)
    img_h, rect_h = b.spec_tile(0, zmin=-100.0, zmax=-20.0,
                                quantize=True)
    assert img_h.size and img_h.shape == img_d.shape
    assert rect_h == rect_d
    assert np.max(np.abs(img_h.astype(int) - img_d.astype(int))) <= 2


def test_mid_render_loss_restricts_host_recompute_to_span(
        outage_browser, monkeypatch):
    """A device loss caught mid-render (inside a tiler, not inside
    ``update_times``) must hand the host fallback the VISIBLE span —
    recomputing every visible trace over the whole buffer in scipy
    float64 freezes the host for the full buffer length where
    the span costs ~the view width."""
    b = outage_browser
    b.set_times(3.0, 1.0)  # view [3, 4] s, nothing rendered yet
    spans = []
    real = b.data._host_windows

    def spy(targets=None, span=None):
        spans.append(span)
        return real(targets=targets, span=span)

    monkeypatch.setattr(b.data, "_host_windows", spy)
    monkeypatch.setattr(watch, "_lost", True)
    t, v = b.trace_tile("filtered", 0)
    assert len(v) and np.all(np.isfinite(v))
    assert spans and spans[0] is not None, \
        "mid-render fallback recomputed the full buffer"
    g0, g1 = spans[0]
    rate = b.data.rate
    # the span covers the view plus the session halos, like
    # Data.update_times' own loss path
    assert g0 <= int(3.0 * rate) and g1 >= int(4.0 * rate)
    assert g0 >= int((3.0 - b.data.tbefore) * rate) - 1
    assert g1 <= int((4.0 + b.data.tafter) * rate) + 2


def test_qt_status_bar_shows_device_note(tmp_path, rng, monkeypatch):
    """The Qt frontend surfaces "device lost — host mode" in the status
    bar on its refresh path and clears it on recovery."""
    import qtcompat as qtc
    from audian_tpu.app.shell import Audian

    qt, qt_teardown = qtc.setup_backend("fake")
    rate = 8000.0
    x = (0.2 * rng.standard_normal((8000, 1))).astype(np.float32)
    p = tmp_path / "r.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    shell = Audian([str(p)])
    shell.load_files()
    win = qt.AudianWindow(shell)
    qtc.show_window(qt, win)
    try:
        tab = win.tabs.widget(0)
        monkeypatch.setattr(watch, "_lost", True)
        tab.refresh()
        assert "device lost" in win.statusBar().currentMessage()
        monkeypatch.setattr(watch, "_lost", False)
        tab.refresh()
        assert win.statusBar().currentMessage() == ""
    finally:
        for i in range(win.tabs.count()):
            win.tabs.widget(i).teardown()
        win.close()
        qtc.process_events(qt)
        qt_teardown()


def test_runtime_error_with_dead_heartbeat_becomes_deviceloss(
        fast_watch, monkeypatch):
    """A device that dies by FAILING calls raises a jax
    runtime error instead of hanging; with a dead heartbeat that is the
    same outage and must engage the host fallbacks as DeviceLost."""
    import jax

    err = jax.errors.JaxRuntimeError("socket closed")
    monkeypatch.setattr(fast_watch, "_probe", lambda: time.sleep(60))

    def boom():
        raise err

    with pytest.raises(DeviceLost):
        fast_watch.pull(boom)
    assert fast_watch.lost


def test_runtime_error_with_alive_heartbeat_propagates(fast_watch,
                                                       monkeypatch):
    """A runtime error while the device answers is a PROGRAM error —
    it must propagate unchanged, not silently degrade to host mode."""
    import jax

    monkeypatch.setattr(fast_watch, "_probe", lambda: True)

    def boom():
        raise jax.errors.JaxRuntimeError("bad program")

    with pytest.raises(jax.errors.JaxRuntimeError, match="bad program"):
        fast_watch.pull(boom)
    assert not fast_watch.lost


def test_mpl_frontend_shows_device_note(outage_browser, monkeypatch):
    """The matplotlib frontend surfaces "device lost — host mode" on
    its redraw path (the Qt twin is pinned in
    test_qt_status_bar_shows_device_note)."""
    import matplotlib

    matplotlib.use("Agg")
    from audian_tpu.gui.mpl import MplBrowserWindow

    win = MplBrowserWindow(outage_browser)
    try:
        monkeypatch.setattr(watch, "_lost", True)
        win.redraw()
        sup = win.fig._suptitle
        assert sup is not None and "device lost" in sup.get_text()
        monkeypatch.setattr(watch, "_lost", False)
        win.redraw()
        assert "device lost" not in win.fig._suptitle.get_text()
    finally:
        win.close()


def test_hover_loss_does_not_truncate_sibling_windows(outage_browser,
                                                      monkeypatch):
    """A device loss caught in the power hover readout (a one-off)
    recomputes ONLY the spectrogram trace — it must not replace every
    visible trace's window with a one-frame sliver (which blanked the
    whole view until the next scroll)."""
    import jax

    b = outage_browser
    b.set_times(2.0, 1.0)
    filt_before = b.data["filtered"].buffer
    assert isinstance(filt_before, jax.Array)
    monkeypatch.setattr(watch, "_lost", True)
    ro = b.hover_readout(2.5, y=1000.0, kind="spec", channel=0)
    assert ro is not None
    # the spectrogram (and its upstream dependency, recomputed as a
    # byproduct) flipped to host mode over the FULL window — nothing
    # was truncated to the hover's one-frame span
    spec = b.data[b.spectrogram]
    assert isinstance(spec.buffer, np.ndarray)
    assert len(spec.buffer) > 2, "spectrogram window truncated to a sliver"
    filt = b.data["filtered"]
    assert len(filt.buffer) == len(filt_before), \
        "hover loss truncated the filtered window"
    # a later tile render of the sibling takes its own span-limited flip
    t, v = b.trace_tile("filtered", 0)
    assert len(v) and np.all(np.isfinite(v))


def test_spec_tile_loss_recompute_is_bounded(outage_browser,
                                             monkeypatch):
    """A loss during the spectrogram tile path never triggers an
    UNBOUNDED host recompute: every fallback carries either a target
    list (the levels path recomputes only the spec trace) or a span
    (the tiler's loss_span), and the sibling traces keep their device
    windows."""
    import jax

    b = outage_browser
    b.set_times(4.0, 1.0)
    calls = []
    real = b.data._host_windows

    def spy(targets=None, span=None):
        calls.append((targets, span))
        return real(targets=targets, span=span)

    monkeypatch.setattr(b.data, "_host_windows", spy)
    monkeypatch.setattr(watch, "_lost", True)
    img, rect = b.spec_tile(0, quantize=True)
    assert img.size
    assert calls
    for targets, span in calls:
        assert targets is not None or span is not None, \
            "unbounded full-buffer recompute of every visible trace"


def test_spec_tiler_loss_span_limits_host_recompute(outage_browser,
                                                    monkeypatch):
    """The tiler-level loss_span: a loss inside SpecTiler.tile on a
    device-resident window hands _host_windows the visible span."""
    b = outage_browser
    b.set_times(4.0, 1.0)
    trace = b.data[b.spectrogram]
    spans = []
    real = b.data._host_windows

    def spy(targets=None, span=None):
        spans.append(span)
        return real(targets=targets, span=span)

    monkeypatch.setattr(b.data, "_host_windows", spy)
    monkeypatch.setattr(watch, "_lost", True)
    img, rect = b.spec_tiler.tile(trace, 0, -100.0, -20.0,
                                  quantize=True, loss_span=(4.0, 5.0))
    assert img.size
    assert spans and spans[0] is not None, \
        "loss_span was not forwarded to the host fallback"
