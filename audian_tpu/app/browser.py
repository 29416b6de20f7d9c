"""Headless per-recording controller — the GUI-independent core of the
reference's ``DataBrowser`` (`src/audian/databrowser.py:53-1926`).

Owns one :class:`audian_tpu.data.Data` (raw loader + device trace graph),
the analyzers, the marker store, the channel-selection state, the region
verbs (zoom/play/analyze/save), and the interactive parameter verbs
(filter cutoffs, NFFT/overlap, envelope cutoff).  GUI frontends (Qt or
matplotlib) subclass or wrap it and subscribe to its signals, which are
plain callback lists here.

The reference's ``self.setting`` reentrancy flag
(`databrowser.py:1127-1136`) is kept with identical semantics to break
signal feedback loops between linked views.
"""

from __future__ import annotations

from copy import deepcopy
from pathlib import Path

import numpy as np
import jax

from ..data import Data, wavio
from ..data.data import RAW
from ..ops import prepare_playback
from ..analysis import (Plugins, PlainAnalyzer, StatisticsAnalyzer,
                        EventRecorder)
from ..cache import FullTraceData
from ..view.render import (TraceTiler, SpecTiler, noise_level_stats,
                           host_noise_level_stats, mean_power_db_slice)
from ..utils.devicewatch import DeviceLost, watch as _devwatch
from ..utils import trace as _trace
from .markers import MarkerData, MarkerLabel


def secs_to_str(time):
    """``1h30m05.25s``-style time formatting
    (`src/audian/fulltraceplot.py:17-59` semantics)."""
    hours = int(time // 3600)
    mins = int((time % 3600) // 60)
    secs = time % 60
    s = ""
    if hours > 0:
        s += f"{hours}h"
    if mins > 0 or hours > 0:
        s += f"{mins:02d}m" if s else f"{mins}m"
    if secs == int(secs):
        s += f"{int(secs):02d}s" if s else f"{secs:.0f}s"
    else:
        sstr = f"{secs:.4g}"
        if s:  # pad the INTEGER part to two digits ('1m05.25s')
            ip, _, fp = sstr.partition(".")
            sstr = ip.zfill(2) + ("." + fp if fp else "")
        s += sstr + "s"
    return s


class Signal:
    """Tiny Qt-signal stand-in: a list of callbacks."""

    def __init__(self):
        self._slots = []

    def connect(self, fn):
        self._slots.append(fn)

    def disconnect(self, fn):
        self._slots.remove(fn)

    def emit(self, *args):
        for fn in list(self._slots):
            fn(*args)


class DataBrowser:
    """Headless controller for one (multi-file) recording."""

    # region modes (`src/audian/databrowser.py:67-71`)
    zoom_region = 0
    play_region_mode = 1
    analyze_region_mode = 2
    save_region_mode = 3
    ask_region = 4

    # spectrogram color maps (`src/audian/databrowser.py:53-65`); GUI
    # frontends map these colorcet names onto their own colormap objects
    color_maps = ["CET-R4", "CET-L8", "CET-L16", "CET-CBL2", "CET-L1",
                  "CET-L3"]

    # visible trace-panel height fraction per show_specs level
    # (`src/audian/databrowser.py:118`)
    trace_fracs = {0: 1, 1: 1, 2: 0.5, 3: 0.25, 4: 0.15}

    def __init__(self, file_path, channels=None, plugins=None,
                 buffer_time=60.0, back_time=20.0, load_kwargs=None,
                 unwrap=0.0, unwrap_clip=False, mesh=None):
        self.file_path = file_path
        self.load_kwargs = dict(load_kwargs or {})
        self.unwrap = unwrap
        self.unwrap_clip = unwrap_clip
        self.plugins = plugins or Plugins()
        # mesh: channel-shard the interactive session across chips
        # (Data docstring; the browser itself is sharding-agnostic)
        self.data = Data(file_path, buffer_time=buffer_time,
                         back_time=back_time, mesh=mesh,
                         **self.load_kwargs)
        self._requested_channels = channels
        self.show_channels = []
        self.selected_channels = []
        self.current_channel = 0
        self.analyzers = []
        self.region_mode = DataBrowser.ask_region
        self.setting = False
        # active spectrogram trace (`databrowser.py:122-124`)
        self.spectrogram = ""
        self.spectrogram_power = ""
        # panel visibility state (`databrowser.py:126-131`)
        self.grids = 0
        self.show_traces = True
        self.show_specs = 1
        self.show_powers = False
        self.show_cbars = False
        self.show_fulldata = True
        self.color_map = 0
        # auto scroll (`databrowser.py:134`)
        self.scroll_step = 0.0
        self.scroll_active = False
        # view window state (the 't' plot range's role for time)
        self.toffset = 0.0
        self.twindow = 2.0
        # audio playback state (`databrowser.py:128-146`)
        self.audio_rate_fac = 1.0
        self.audio_use_heterodyne = False
        self.audio_heterodyne_freq = 0.0
        self.audio_time = -1.0
        self.audio_tmax = 0.0
        # render engines
        self.trace_tiler = TraceTiler()
        self.spec_tiler = SpecTiler()
        self._resolutions_warmed = False
        self._warm_thread = None
        self._closed = False
        self._warmed_nffts = set()   # buckets with compiled programs
        self._pending_nfft = None    # requested-but-unwarmed bucket
        self._power_level_stats = None  # (window, per-channel levels)
        self.fulltrace = None
        # view model (Panels + PlotRanges over headless axes), built in open()
        self.panels = None
        self.plot_ranges = None
        # marker store
        self.marker_labels = [MarkerLabel("start", "s", "yellow"),
                              MarkerLabel("end", "e", "blue")]
        self.marker_data = MarkerData(self.marker_labels)
        self.save_path = None
        # signals (Qt-free)
        self.sigTimesChanged = Signal()
        self.sigFilenameChanged = Signal()
        self.sigFilterChanged = Signal()
        self.sigResolutionChanged = Signal()
        self.sigEnvelopeChanged = Signal()
        self.sigChannelsChanged = Signal()
        self.sigAudioChanged = Signal()
        self.sigAnalysisChanged = Signal()
        self.sigColorMapChanged = Signal()
        self.sigTraceChanged = Signal()
        self.sigPanelsChanged = Signal()
        self.sigRangesChanged = Signal()
        self.plugins.setup_traces(self)
        self.data.setup_traces()

    # -- construction hooks (plugin/analyzer protocol) ---------------------------

    def add_trace(self, node):
        self.data.add_trace(node)

    def add_analyzer(self, analyzer):
        self.analyzers.append(analyzer)

    def make_event_item(self, channel=0, trace_name=None, panel_name=None,
                        symbol=None, color=None, size=None):
        """Event-marker sink factory.  Always returns a placement-aware
        :class:`EventRecorder`; the frontends pull the recorded points
        into their own scatter artists on refresh (the reference instead
        pushes ScatterPlotItems into the plots at creation time,
        `src/audian/analyzer.py:186-252`, `databrowser.py:243-245`)."""
        return EventRecorder(symbol, color, size, channel=channel,
                             trace_name=trace_name, panel_name=panel_name)

    def iter_event_items(self):
        """Yield every live analyzer event recorder as
        ``(analyzer, event_name, recorder)`` — the frontends' render
        source for analyzer markers."""
        for a in self.analyzers:
            for name, items in a.events.items():
                for rec in items:
                    yield a, name, rec

    # -- lifecycle ----------------------------------------------------------------

    def open(self):
        # compile the device-loss heartbeat FIRST: its tiny compile must
        # win the compile lock before the chain compiles queue up, so
        # watchdog pulses run warm from the first scroll
        # (`utils/devicewatch.py:_default_probe` for the measurements)
        _devwatch.warm_async()
        self.data.open(self.unwrap, self.unwrap_clip)
        channels = self._requested_channels
        if channels:
            self.show_channels = [c for c in channels
                                  if 0 <= c < self.data.channels]
        else:
            self.show_channels = list(range(self.data.channels))
        if not self.show_channels:
            self.show_channels = [0]
        self.selected_channels = list(self.show_channels)
        self.current_channel = self.show_channels[0]
        self.twindow = min(2.0, self.data.frames / self.data.rate)
        # markers from file metadata (`databrowser.py:317-324`)
        locs, labels = self.data.data.markers()
        self.marker_data.set_markers(locs, labels, self.data.rate)
        for lbl in np.unique(labels[:, 0]) if len(labels) else []:
            if not any(l.label == lbl for l in self.marker_labels):
                self.marker_labels.append(
                    MarkerLabel(str(lbl), str(lbl)[:1].lower(), "white"))
        # active spectrogram trace (`databrowser.py:122-123`)
        from ..graph.nodes import SpectrogramNode

        specs = self.data.get_trace_names(SpectrogramNode)
        self.spectrogram = specs[0] if specs else ""
        self.show_specs = 1 if self.spectrogram else 0
        # analyzers: plain + statistics + plugins (`databrowser.py:613-615`)
        PlainAnalyzer(self)
        if "filtered" in self.data:
            StatisticsAnalyzer(self)
        self.plugins.setup_analyzers(self)
        # view model: panels + linked per-letter plot ranges over headless
        # axes (`databrowser.py:263-442` builds the same structures over
        # pyqtgraph plots)
        from ..view.headless import build_view_model

        self.panels, self.plot_ranges = build_view_model(self)
        # overview
        self.fulltrace = FullTraceData(self.data.data)
        if not self.fulltrace.load_data():
            self.fulltrace.start(6000)
        self.set_times(0.0, self.twindow)
        return self

    def close(self):
        # stop the background warm after its in-flight bucket: a daemon
        # thread force-killed INSIDE an XLA call at interpreter exit
        # aborts the whole process with a C++ terminate (observed), so
        # the warm loop polls this flag and the atexit hook below joins
        # survivors before finalization begins
        self._closed = True
        if self.fulltrace is not None:
            self.fulltrace.close()
        self.data.close()

    # -- time window ---------------------------------------------------------------

    def set_times(self, toffset=None, twindow=None):
        """Move/resize the visible window and recompute visible traces
        (`databrowser.py:1126-1136`)."""
        if self.setting:
            return
        self.setting = True
        try:
            if toffset is not None:
                self.toffset = max(0.0, toffset)
            if twindow is not None:
                self.twindow = twindow
            tmax = self.data.frames / self.data.rate
            if self.toffset + self.twindow > tmax:
                self.toffset = max(0.0, tmax - self.twindow)
            fn = self.data.update_times(self.toffset,
                                        self.toffset + self.twindow)
            if self.plot_ranges is not None:
                self.plot_ranges["t"].set_ranges(
                    self.toffset, self.toffset + self.twindow)
            self.sigFilenameChanged.emit(self, fn)
            self.sigTimesChanged.emit(self.toffset, self.twindow)
        finally:
            self.setting = False

    # time verbs (keyboard surface of the reference)
    def time_page_down(self):
        self.set_times(self.toffset + 0.5 * self.twindow)

    def time_page_up(self):
        self.set_times(self.toffset - 0.5 * self.twindow)

    def time_zoom_in(self):
        self.set_times(twindow=self.twindow / 2)

    def time_zoom_out(self):
        self.set_times(twindow=min(self.twindow * 2,
                                   self.data.frames / self.data.rate))

    def time_home(self):
        self.set_times(0.0)

    def time_end(self):
        self.set_times(self.data.frames / self.data.rate - self.twindow)

    # -- linked axis ranges (`databrowser.py:1092-1177`) ------------------------------

    def apply_time_ranges(self, timefunc):
        """Apply a time verb through the 't' plot range
        (`databrowser.py:1139-1149`)."""
        getattr(self.plot_ranges, timefunc)("t")
        tr = self.plot_ranges["t"]
        self.set_times(tr.r0[0], tr.r1[0] - tr.r0[0])

    def set_ranges(self, axspec, r0=None, r1=None):
        """Set one axis letter's range on the selected channels
        (`databrowser.py:1152-1160`)."""
        if self.setting:
            return
        self.setting = True
        try:
            self.plot_ranges[axspec].set_ranges(r0, r1, None,
                                                self.selected_channels)
        finally:
            self.setting = False

    def apply_ranges(self, amplitudefunc, axspec):
        """Apply a range verb (zoom_in/out, up/down, auto, reset, center,
        …) to every letter of ``axspec`` on the selected channels
        (`databrowser.py:1162-1167`), then dispatch."""
        if self.setting:
            return
        if amplitudefunc == "auto":
            # `auto` alone among the verbs needs the visible time span
            # (PlotRange.auto(t0, t1, channels)) — route it through
            # auto_ampl, which supplies it; the generic broadcast below
            # would bind the channel list to t0 and TypeError
            return self.auto_ampl(axspec)
        self.setting = True
        try:
            getattr(self.plot_ranges, amplitudefunc)(axspec,
                                                     self.selected_channels)
        finally:
            self.setting = False
        self._emit_ranges(axspec)

    def auto_ampl(self, axspec="xyu"):
        """Auto-scale amplitudes to the visible window's extrema
        (`databrowser.py:1170-1177`)."""
        if self.setting:
            return
        self.setting = True
        try:
            self.plot_ranges.auto(axspec, self.toffset,
                                  self.toffset + self.twindow,
                                  self.selected_channels)
        finally:
            self.setting = False
        self._emit_ranges(axspec)

    def set_powers(self):
        """Noise-floor based spectrogram color levels on every power axis
        (`plotranges.py:461-478` via `databrowser.py:1134`)."""
        self.plot_ranges.set_powers()

    def get_range(self, letter, channel=0):
        """Current [r0, r1] of one axis letter (GUI read-back)."""
        r = self.plot_ranges[letter]
        return r.r0[channel], r.r1[channel]

    def _emit_ranges(self, axspec):
        """Emit (axspec, [(r0, r1), ...]) for link dispatch
        (`databrowser.py:1092-1106` update_ranges → sigRangesChanged)."""
        c = self.current_channel
        arange = [self.get_range(s, c) for s in axspec]
        self.sigRangesChanged.emit(self, axspec, arange)

    # -- crosshair + stored marker (`plotranges.py:481-660`) ---------------------------

    def set_crosshair(self, channel, t=None, amplitude=None, frequency=None,
                      power=None, ampl_letter="x", freq_letter="f",
                      power_letter="p"):
        """Place the crosshair; each position lands on its axis letter's
        shared range object so readouts work across panels."""
        pr = self.plot_ranges
        pr.clear_marker()
        for letter, pos in (("t", t), (ampl_letter, amplitude),
                            (freq_letter, frequency), (power_letter, power)):
            if pos is not None:
                pr[letter].set_marker(channel, None, pos)
        pr.update_crosshair()

    def crosshair_readout(self):
        """(time, amplitude, frequency, power) positions plus deltas vs the
        stored marker — the toolbar readout set
        (`databrowser.py:851-906`)."""
        pr = self.plot_ranges
        return {
            "time": pr.marker_time()[1],
            "amplitude": pr.marker_amplitude()[1],
            "frequency": pr.marker_frequency()[1],
            "power": pr.marker_power()[1],
            "delta_time": pr.marker_delta_time()[1],
            "delta_amplitude": pr.marker_delta_amplitude()[1],
            "delta_frequency": pr.marker_delta_frequency()[1],
            "delta_power": pr.marker_delta_power()[1],
        }

    def store_marker(self, label="", text=""):
        """Record the crosshair as a marker-table row with its deltas and
        freeze it as the stored marker (`databrowser.py:909-939`
        click-storing plus `markerdata.py` add_data)."""
        pr = self.plot_ranges
        t = pr.marker_time()[1]
        if t is None:
            return None
        ro = self.crosshair_readout()
        channel = next((pr[s].marker_channel for s in "txyufwpq"
                        if pr[s].marker_channel is not None), 0)
        self.marker_data.add_data(
            channel, t, ro["amplitude"], ro["frequency"], ro["power"],
            ro["delta_time"], ro["delta_amplitude"], ro["delta_frequency"],
            ro["delta_power"], label, text)
        pr.store_marker()
        return len(self.marker_data) - 1

    def clear_crosshair(self):
        self.plot_ranges.clear_marker()
        self.plot_ranges.update_crosshair()

    # -- interactive parameters -----------------------------------------------------

    def update_filter(self, highpass_cutoff=None, lowpass_cutoff=None):
        """(`databrowser.py:1264-1288`)"""
        if self.setting or "filtered" not in self.data:
            return
        self.setting = True
        try:
            self.data["filtered"].update(highpass_cutoff=highpass_cutoff,
                                         lowpass_cutoff=lowpass_cutoff)
        finally:
            self.setting = False
        self.sigFilterChanged.emit()

    def step_filter(self, hp_fac=None, lp_fac=None):
        """Step the filter cutoffs by multiplicative factors — the
        keyboard verb both frontends bind (f/F and l/L).

        Single-sourced semantics so the frontends cannot diverge: a
        rising highpass lifts off the 0 Hz default at a 10 Hz floor and
        stepping below 10 Hz turns it off again; the lowpass steps from
        (and clamps back to) Nyquist.  Both cutoffs clamp to Nyquist so
        repeated up-steps never run away into stored values the
        opposite verb must silently unwind before anything audible
        changes."""
        if "filtered" not in self.data:
            return
        f = self.data["filtered"]
        nyq = self.data.rate / 2
        hp = lp = None
        if hp_fac:
            hp = f.highpass_cutoff * hp_fac
            if hp_fac > 1:
                hp = min(max(hp, 10.0), nyq)
            elif hp < 10.0:
                hp = 0.0
        if lp_fac:
            lp = min((f.lowpass_cutoff or nyq) * lp_fac, nyq)
        self.update_filter(hp, lp)

    def set_resolution(self, nfft=None, overlap_frac=None, dispatch=True,
                       step_frac=None):
        """NFFT / overlap changes (`databrowser.py:1188-1222`).

        While the background warm (:meth:`warm_resolutions_async`) is
        still filling the ladder, an interactive step
        (``dispatch=True``) into a bucket whose programs have not
        landed yet is served by the NEAREST warmed bucket immediately —
        never an inline compile of many seconds — and the requested
        bucket is remembered; the GUI timers poll
        :meth:`poll_pending_resolution` and swap the view to it the
        moment its programs land."""
        if self.setting or self.spectrogram not in self.data:
            return
        if nfft is not None and dispatch:
            nfft = int(nfft)
            warm = self._warm_thread
            # snapshot: the warm thread adds to the set concurrently.
            # The session's CURRENT bucket counts as warmed — its
            # programs compiled when it was first rendered — so a
            # keypress BEFORE the warm lands its first bucket still
            # snaps (to "stay put") instead of compiling inline
            warmed = set(self._warmed_nffts)
            warmed.add(int(self.data[self.spectrogram].nfft))
            if (warm is not None and warm.is_alive()
                    and nfft >= 8 and nfft not in warmed):
                self._pending_nfft = nfft
                target = nfft
                nfft = min(warmed,
                           key=lambda w: (abs(np.log2(w / target)), w))
            else:
                self._pending_nfft = None
        self.setting = True
        try:
            if overlap_frac is None and step_frac is not None:
                overlap_frac = 1.0 - step_frac
            self.data[self.spectrogram].update(nfft=nfft,
                                               overlap_frac=overlap_frac)
        finally:
            self.setting = False
        if dispatch:
            self.sigResolutionChanged.emit()

    @property
    def has_pending_resolution(self):
        return self._pending_nfft is not None

    def poll_pending_resolution(self):
        """Apply a remembered resolution once its programs are warm.

        Called from the frontends' timer ticks (UI thread — the warm
        thread only ever publishes into ``_warmed_nffts``, it never
        touches browser state).  Returns True when the pending bucket
        was just applied (callers replot), False otherwise."""
        pending = self._pending_nfft
        if pending is None:
            return False
        warm = self._warm_thread
        warm_alive = warm is not None and warm.is_alive()
        if pending in self._warmed_nffts or not warm_alive:
            # warmed — or the warm thread is gone (done or failed), in
            # which case serving the stale bucket forever is worse than
            # one inline compile
            self._pending_nfft = None
            self.set_resolution(nfft=pending)
            return True
        return False

    @staticmethod
    def warm_ladder():
        """The warm visiting order: the core interactive band first
        (`ops/sweep.py:SWEEP_NFFTS`), then the rest of the reference's
        full UI ladder 2^3..2^19 (`databrowser.py:516`) by distance from
        the core — so the buckets a user is most likely to step into are
        compile-free earliest, and eventually ALL of them are."""
        from ..ops.sweep import FULL_NFFTS, SWEEP_NFFTS

        below = sorted((n for n in FULL_NFFTS
                        if n < min(SWEEP_NFFTS)), reverse=True)
        above = sorted(n for n in FULL_NFFTS if n > max(SWEEP_NFFTS))
        return tuple(SWEEP_NFFTS) + tuple(below) + tuple(above)

    def warm_resolutions(self, nffts=None, on_warm=None, stop=None):
        """Precompile the interactive NFFT sweep: visit every bucket once
        through the real ``set_resolution`` + tile + power path, so later
        resolution scrubbing is compile-free (the batched-sweep contract
        of BASELINE config 4; `ops/sweep.py` holds the single-launch
        variant used by the batch tools).  Default coverage is the FULL
        reference UI ladder 2^3..2^19, core band first
        (:meth:`warm_ladder`); buckets the recording length clamps away
        are skipped.  ``on_warm(nfft)`` fires after each bucket's
        programs land (the async warm uses it to publish progress to the
        live session's ``_warmed_nffts``).  ``stop()`` is polled
        between buckets so a closing session abandons the remaining
        sweep after at most one in-flight compile.  Idempotent; returns
        the number of buckets warmed (0 when already warm or no
        spectrogram)."""
        if self._resolutions_warmed or self.spectrogram not in self.data:
            return 0
        trace = self.data[self.spectrogram]
        saved_nfft, saved_overlap = trace.nfft, trace.overlap_frac
        probe = self.show_channels[0] if self.show_channels else 0
        count = 0
        stopped = False
        for nfft in tuple(nffts) if nffts else self.warm_ladder():
            if stop is not None and stop():
                stopped = True
                break
            self.set_resolution(nfft=nfft, dispatch=False)
            if trace.nfft != int(nfft):
                continue  # clamped away (very short recordings)
            for c in range(self.data.channels):
                # both tile flavors: quantize is a static jit arg, and
                # the GUIs pull u8 while the API default is normalized
                self.spec_tile(c)
                self.spec_tile(c, quantize=True)
            self.power_spectrum(probe)
            self.estimate_power_levels(probe)
            self._warmed_nffts.add(int(nfft))
            if on_warm is not None:
                on_warm(int(nfft))
            count += 1
        self.set_resolution(nfft=saved_nfft, overlap_frac=saved_overlap,
                            dispatch=False)
        if not stopped:
            # an aborted sweep must NOT record itself as complete: the
            # flag would make every later warm a no-op and push the
            # remaining buckets' 10-60 s compiles onto the first
            # resolution keypress
            self._resolutions_warmed = True
        return count

    def warm_resolutions_async(self, nffts=None):
        """Warm the NFFT sweep in the background WITHOUT blocking the
        first keypress or touching this browser's state: a throwaway
        headless clone of this session (same recording, channels, and
        aligned window geometry — hence identical program shapes) visits
        every bucket through the real warm path on a daemon thread.

        The render-side jits are module-level, so the clone fills the
        same in-process caches this browser's first scrub will read; the
        per-session graph programs land in the persistent XLA
        compilation cache, where this session's first visit of each
        bucket picks them up without compiling.  Returns the started thread, or ``None``
        when there is nothing to warm."""
        if self._resolutions_warmed or self.spectrogram not in self.data:
            return None
        import threading

        import audian_tpu

        audian_tpu.enable_compilation_cache()
        t0, t1 = self.toffset, self.toffset + self.twindow
        channels = list(self.show_channels) or None

        def work():
            clone = None
            try:
                clone = DataBrowser(
                    self.file_path, channels=channels,
                    plugins=(self.plugins.snapshot()
                             if self.plugins is not None else None),
                    buffer_time=self.data.buffer_time,
                    back_time=self.data.back_time,
                    load_kwargs=self.load_kwargs, unwrap=self.unwrap,
                    unwrap_clip=self.unwrap_clip, mesh=self.data.mesh)
                clone.open()
                clone.set_times(t0, t1 - t0)
                # publish per-bucket progress into the live session so
                # interactive steps snap to warmed buckets mid-warm and
                # poll_pending_resolution() can swap pending ones in
                clone.warm_resolutions(
                    nffts, on_warm=self._warmed_nffts.add,
                    stop=lambda: self._closed or _warm_stop.is_set())
            except Exception:
                pass  # best-effort prefetch; the UI path stays correct
            finally:
                if clone is not None:
                    try:
                        clone.close()
                    except Exception:
                        pass

        th = threading.Thread(target=work, daemon=True,
                              name="audian-warm-resolutions")
        th.start()
        self._warm_thread = th
        _live_warm_threads.add(th)
        return th

    # resolution step verbs (`databrowser.py:1225-1245`): a step compiles
    # only its own bucket — the full sweep warms in the background
    # (warm_resolutions_async) or on an explicit warm_resolutions() call,
    # never inline on the first keypress (a cold persistent cache would
    # stall it for the length of the compiles)
    def _nfft_bucket_range(self):
        """(lo, hi) of the steppable pow2 NFFT ladder: the reference UI
        bounds 2^3..2^19 (`databrowser.py:516`), with hi further capped
        to the largest pow2 the recording length admits — the node
        would clamp an overshooting step to ``frames//2``, a non-pow2
        bucket the background warm never visited, and that keypress
        would compile inline."""
        from ..ops.sweep import FULL_NFFTS

        hi = FULL_NFFTS[-1]
        frames = self.data[self.spectrogram].source_spec.frames
        while hi > FULL_NFFTS[0] and hi > frames // 2:
            hi //= 2
        return FULL_NFFTS[0], hi

    def _nfft_step_base(self):
        # while a snapped step waits for the warm, further steps count
        # from the REQUESTED bucket, not the displayed stand-in —
        # pressing up 3x mid-warm must land 3 octaves up, not 1
        return self._pending_nfft or self.data[self.spectrogram].nfft

    def freq_resolution_down(self):
        if self.spectrogram in self.data:
            lo, _hi = self._nfft_bucket_range()
            nfft = self._nfft_step_base() // 2
            if nfft >= lo:
                self.set_resolution(nfft=nfft)

    def freq_resolution_up(self):
        if self.spectrogram in self.data:
            _lo, hi = self._nfft_bucket_range()
            nfft = 2 * self._nfft_step_base()
            if nfft <= hi:
                self.set_resolution(nfft=nfft)

    def overlap_frac_up(self):
        if self.spectrogram in self.data:
            hop_frac = 1 - self.data[self.spectrogram].overlap_frac
            self.set_resolution(overlap_frac=1 - hop_frac / 2)

    def overlap_frac_down(self):
        if self.spectrogram in self.data:
            hop_frac = 1 - self.data[self.spectrogram].overlap_frac
            self.set_resolution(overlap_frac=1 - hop_frac * 2)

    def set_spectrogram(self, checked, spec):
        """Select which spectrogram trace the resolution verbs, power
        readouts, and tiles act on (`databrowser.py:1180-1185`)."""
        if checked and spec in self.data:
            self.spectrogram = spec
            self.set_resolution()

    # -- color maps (`databrowser.py:1247-1261`) -----------------------------------

    def set_color_map(self, color_map=None, dispatch=True):
        if color_map is not None:
            self.color_map = int(color_map) % len(self.color_maps)
        if dispatch:
            self.sigColorMapChanged.emit()

    def color_map_cycler(self):
        self.color_map += 1
        if self.color_map >= len(self.color_maps):
            self.color_map = 0
        self.set_color_map()

    @property
    def color_map_name(self):
        return self.color_maps[self.color_map]

    def update_envelope(self, envelope_cutoff=None, show_envelope=None,
                        dispatch=True):
        """(`databrowser.py:1291-1314`)"""
        if self.setting or "envelope" not in self.data:
            return
        self.setting = True
        try:
            if envelope_cutoff is not None:
                self.data["envelope"].update(envelope_cutoff=envelope_cutoff)
            if show_envelope is not None:
                for name in self.data.keys():
                    if name.startswith("env"):
                        self.data.set_visible(name, show_envelope)
        finally:
            self.setting = False
        if dispatch:
            self.sigEnvelopeChanged.emit()

    # -- trace / analyzer management (`databrowser.py:197-260`) ----------------------

    @property
    def name(self):
        """Recording base name (`databrowser.py:197-204`)."""
        if self.data.data is not None:
            return Path(self.data.data.basename()).stem
        fp = self.data.file_path
        if isinstance(fp, (list, tuple, np.ndarray)):
            return Path(fp[0]).stem
        return Path(fp).stem

    def get_trace(self, name):
        return self.data[name]

    def remove_trace(self, name):
        self.data.remove_trace(name)

    def clear_traces(self):
        self.data.clear_traces()

    def get_analyzer(self, name):
        for a in self.analyzers:
            if name.lower() == a.name.lower():
                return a
        return None

    def remove_analyzer(self, name):
        for k, a in enumerate(self.analyzers):
            if name.lower() == a.name.lower():
                del self.analyzers[k]
                return

    def clear_analyzer(self):
        self.analyzers = []

    def toggle_trace(self, checked, name):
        """Show/hide one derived trace; hidden traces stop computing
        (`databrowser.py:248-252` — the laziness gate)."""
        self.data.set_visible(name, checked)
        self.set_times()
        self.sigTraceChanged.emit(self, checked, name)

    def set_trace(self, checked, name):
        """Like :meth:`toggle_trace` but without dispatch
        (`databrowser.py:254-260`)."""
        self.data.set_visible(name, checked)

    def metadata_rows(self):
        """Flattened (indent-level, key, value) rows of the recording's
        metadata — the data behind the reference's metadata dialog
        (`databrowser.py:677-724`); GUI frontends render these."""

        def walk(md, level, rows):
            for k, v in md.items():
                if isinstance(v, dict):
                    rows.append((level, str(k), None))
                    walk(v, level + 1, rows)
                else:
                    if isinstance(v, (list, tuple)):
                        v = ", ".join(f"{x}" for x in v)
                    rows.append((level, str(k), f"{v}"))
            return rows

        return walk(self.data.meta_data, 0, [])

    def goto_time(self, file_name, time):
        """Jump the view window to ``time`` within the named source file
        (`databrowser.py:1108-1123`; used by screenshot drag-drop
        navigation)."""
        starts = self.data.data.file_start_times()
        for start, fp in zip(starts, self.data.data.file_paths):
            fp = Path(fp)
            if (fp.name == file_name if "." in file_name
                    else fp.stem.replace("-", "") == file_name):
                self.set_times(start + time)
                return True
        return False

    # -- channel selection --------------------------------------------------------
    # The state machine itself lives in :class:`ChannelFocus`
    # (audian_tpu/app/channels.py); these verbs snapshot the browser's
    # channel state, run one pure operation, and copy the result back,
    # re-normalizing (and emitting) when the operation asks for it.

    def _channel_focus(self):
        from .channels import ChannelFocus
        return ChannelFocus(self.data.channels, self.show_channels,
                            self.selected_channels, self.current_channel)

    def _adopt_focus(self, focus, renormalize=False):
        self.show_channels = list(focus.shown)
        self.selected_channels = list(focus.selected)
        self.current_channel = focus.current
        if renormalize:
            self.set_channels()

    def add_to_show_channels(self, channels):
        focus = self._channel_focus()
        focus.show(channels)
        self._adopt_focus(focus)

    def add_to_selected_channels(self, channels):
        focus = self._channel_focus()
        focus.select(channels)
        self._adopt_focus(focus)

    def all_channels(self):
        """Two-stage select-all (`databrowser.py:1335-1341`): first press
        selects all shown channels, second extends to every channel."""
        focus = self._channel_focus()
        focus.select_all()
        self._adopt_focus(focus)

    def next_channel(self):
        """Focus the next shown channel, scrolling the shown window
        forward at its edge (`databrowser.py:1343-1361`)."""
        focus = self._channel_focus()
        self._adopt_focus(focus, renormalize=focus.step(+1))

    def previous_channel(self):
        """(`databrowser.py:1364-1382`)"""
        focus = self._channel_focus()
        self._adopt_focus(focus, renormalize=focus.step(-1))

    def select_next_channel(self):
        """Extend the selection downward (`databrowser.py:1385-1405`)."""
        focus = self._channel_focus()
        self._adopt_focus(focus, renormalize=focus.extend(+1))

    def select_previous_channel(self):
        """(`databrowser.py:1408-1428`)"""
        focus = self._channel_focus()
        self._adopt_focus(focus, renormalize=focus.extend(-1))

    def set_channels(self, show_channels=None, selected_channels=None,
                     current_channel=None):
        """Normalize channel state and dispatch (`databrowser.py:1431-1460`):
        the current channel is forced into the shown∩selected set."""
        if self.setting:
            return
        self.setting = True
        try:
            from .channels import ChannelFocus
            focus = ChannelFocus(
                self.data.channels,
                self.show_channels if show_channels is None
                else show_channels,
                self.selected_channels if selected_channels is None
                else selected_channels,
                self.current_channel if current_channel is None
                else current_channel)
            focus.normalize()
            self._adopt_focus(focus)
        finally:
            self.setting = False
        self.sigChannelsChanged.emit(self.show_channels)

    def select_channels(self, channels):
        focus = self._channel_focus()
        focus.keep_selection(channels)
        self._adopt_focus(focus)

    def toggle_channel(self, channel, checked=None):
        """Toggle one channel's visibility (`databrowser.py:1463-1494`).
        ``checked`` overrides (the reference reads its menu action)."""
        if self.setting or not 0 <= channel < self.data.channels:
            return
        focus = self._channel_focus()
        if checked is None:
            checked = channel not in focus.shown
        if checked:
            focus.reveal(channel)
        elif channel in focus.shown:
            focus.conceal(channel)
        else:
            return
        self._adopt_focus(focus, renormalize=True)

    def show_channel(self, channel):
        """Show only ``channel``; a second press on the lone shown channel
        restores all channels (`databrowser.py:1496-1505`)."""
        if not 0 <= channel < self.data.channels:
            return
        if self.current_channel == channel and self.show_channels == [channel]:
            self.set_channels(list(range(self.data.channels)))
        else:
            focus = self._channel_focus()
            focus.current = channel
            focus.select(channel)
            self._adopt_focus(focus)
            self.set_channels([channel])

    def hide_deselected_channels(self):
        """(`databrowser.py:1508-1512`)"""
        keep = [c for c in self.show_channels
                if c in self.selected_channels]
        self.set_channels(keep or self.show_channels[:1])

    # -- panel visibility (`databrowser.py:1515-1583`) --------------------------------

    def set_panels(self, traces=None, specs=None, powers=None, cbars=None,
                   fulldata=None):
        """Apply the panel-visibility flags; hiding every spectrogram stops
        its device compute (the laziness gate the reference wires through
        panel visibility, `databrowser.py:1515-1545`)."""
        if traces is not None:
            self.show_traces = traces
        if specs is not None:
            self.show_specs = specs
        if powers is not None:
            self.show_powers = powers
        if cbars is not None:
            self.show_cbars = cbars
        if fulldata is not None:
            self.show_fulldata = fulldata
        if self.spectrogram in self.data:
            self.data.set_visible(self.spectrogram, self.show_specs > 0)
        self.set_times()
        self.sigPanelsChanged.emit()

    def toggle_traces(self):
        self.show_traces = not self.show_traces
        if not self.show_traces:
            self.show_specs = max(self.show_specs, 1)
        self.set_panels()

    def toggle_spectrograms(self):
        """Cycle trace/spectrogram height splits 0..4
        (`databrowser.py:1555-1561`)."""
        self.show_specs += 1
        if self.show_specs > 4:
            self.show_specs = 0
        if self.show_specs == 0:
            self.show_traces = True
        self.set_panels()

    def toggle_colorbars(self):
        self.show_cbars = not self.show_cbars
        self.set_panels()

    def toggle_powers(self):
        self.show_powers = not self.show_powers
        self.set_panels()

    def toggle_fulldata(self):
        self.show_fulldata = not self.show_fulldata
        self.set_panels()

    def toggle_grids(self):
        """Cycle the 2-bit grid mask 3→2→1→0→3 and apply it to every
        panel (`databrowser.py:1579-1583`)."""
        self.grids -= 1
        if self.grids < 0:
            self.grids = 3
        self.panels.show_grid(self.grids)
        self.sigPanelsChanged.emit()

    # -- region modes (`databrowser.py:1586-1642`) -------------------------------------

    def set_region_mode(self, mode):
        self.region_mode = mode

    def handle_region(self, channel, t0, t1, mode=None):
        """Dispatch a selected time region to the active region mode —
        the headless core of the reference's ``region_menu``
        (`databrowser.py:1614-1642`).  Returns ``(verb, result)``; in
        ``ask`` mode returns ``("ask", None)`` so the GUI can pop a menu.
        """
        mode = self.region_mode if mode is None else mode
        if mode == DataBrowser.zoom_region:
            self.set_times(t0, t1 - t0)
            return "zoom", (self.toffset, self.twindow)
        if mode == DataBrowser.play_region_mode:
            return "play", self.play_region(t0, t1)
        if mode == DataBrowser.analyze_region_mode:
            return "analyze", self.analyze(t0, t1, channel)
        if mode == DataBrowser.save_region_mode:
            return "save", self.save_region(t0, t1)
        return "ask", None

    # -- auto scroll (`databrowser.py:1645-1680`) ---------------------------------------

    def play_scroll(self):
        """Space bar: stop auto-scroll if running, stop audio if playing,
        else play the visible window (`databrowser.py:1645-1656`)."""
        if self.scroll_active:
            self.scroll_active = False
            self.scroll_step /= 2
            return "scroll-stopped", None
        if self.audio_time >= 0:
            self.audio_time = -1.0
            return "audio-stopped", None
        return "play", self.play_window()

    def auto_scroll(self):
        """Double the scroll speed; past 1 window/tick wraps to stopped
        (`databrowser.py:1659-1670`)."""
        if self.scroll_step == 0:
            self.scroll_step = 0.005
        elif self.scroll_step > 1.0:
            self.scroll_active = False
            self.scroll_step = 0
            return
        else:
            self.scroll_step *= 2
        self.scroll_active = True

    def scroll_further(self):
        """One 50 ms auto-scroll tick (`databrowser.py:1673-1680`)."""
        tmax = self.data.frames / self.data.rate
        if self.toffset + self.twindow >= tmax:
            self.scroll_active = False
            self.scroll_step /= 2
        else:
            self.set_times(self.toffset + self.twindow * self.scroll_step)

    # -- analysis results (`databrowser.py:1777-1857`) ----------------------------------

    def get_analysis_table(self):
        """Merge all analyzers' result tables row-wise into a list of
        dicts (`databrowser.py:1777-1792`)."""
        table = []
        r = 0
        while True:
            row = {}
            for a in self.analyzers:
                if r < len(a.data):
                    hdr = a.data.header()
                    for c, h in enumerate(hdr):
                        row[h] = a.data[r][c]
            if not row:
                break
            table.append(row)
            r += 1
        return table

    def clear_analysis(self):
        for a in self.analyzers:
            a.clear()
        self.sigAnalysisChanged.emit()

    def save_analysis(self, file_path=None):
        """Write the merged analysis table to CSV
        (`databrowser.py:1834-1857`)."""
        if not self.analyzers or not self.analyzers[0].data.labels:
            return None
        if file_path is None:
            fp = Path(self.data.file_path)
            name = fp.stem + "-analysis.csv"
            file_path = (self.save_path / name if self.save_path
                         else fp.with_name(name))
        table = self.get_analysis_table()
        import csv

        file_path = Path(file_path)
        with file_path.open("w", newline="") as f:
            if table:
                w = csv.DictWriter(f, fieldnames=list(table[0].keys()),
                                   delimiter=";")
                w.writeheader()
                w.writerows(table)
        self.save_path = file_path.parent
        return file_path

    # -- audio --------------------------------------------------------------------

    def set_audio(self, rate_fac=None, use_heterodyne=None,
                  heterodyne_freq=None, dispatch=True):
        if rate_fac is not None:
            self.audio_rate_fac = float(rate_fac)
        if use_heterodyne is not None:
            self.audio_use_heterodyne = bool(use_heterodyne)
        if heterodyne_freq is not None:
            self.audio_heterodyne_freq = float(heterodyne_freq)
        if dispatch:
            self.sigAudioChanged.emit(self.audio_rate_fac,
                                      self.audio_use_heterodyne,
                                      self.audio_heterodyne_freq)

    def play_region(self, t0, t1):
        """Build the playback buffer on device: mean mix-down of shown
        channels, optional heterodyne + AA-decimation, fades
        (`databrowser.py:1702-1742`).  Returns (buffer, rate); the GUI
        layer hands it to the sound device."""
        trace = self.data["filtered"] if "filtered" in self.data else \
            self.data[RAW]
        rate = trace.rate
        i0 = max(int(np.round(t0 * rate)), 0)
        i1 = min(int(np.round(t1 * rate)), len(trace))
        if i1 <= i0:
            return np.zeros((0, 2)), rate
        data = np.asarray(trace[i0:i1, :])
        play, prate = prepare_playback(
            data, rate, channels=self.show_channels,
            use_heterodyne=self.audio_use_heterodyne,
            heterodyne_freq=self.audio_heterodyne_freq,
            rate_fac=self.audio_rate_fac,
        )
        self.audio_time = i0 / rate
        self.audio_tmax = i1 / rate
        return np.asarray(play), prate

    def play_visible(self):
        return self.play_region(self.toffset, self.toffset + self.twindow)

    def play_window(self):
        """(`databrowser.py:1741-1744`)"""
        return self.play_visible()

    def save_window(self):
        """Save the visible window (`databrowser.py:1924-1926`)."""
        return self.save_region(self.toffset, self.toffset + self.twindow)

    def mark_audio(self, dt=0.05):
        """Advance the playback position marker one GUI tick (the
        reference's 50 ms timer, `src/audian/databrowser.py:1745-1756`).
        Returns the marker time or None when playback finished."""
        if self.audio_time < 0:
            return None
        self.audio_time += dt / self.audio_rate_fac
        if self.audio_time > self.audio_tmax:
            self.audio_time = -1.0
            return None
        return self.audio_time

    def time_info(self, t):
        """Hover time rows: recording-relative, absolute, and per-file
        times of ``t`` (`src/audian/timeplot.py:154-192` hover table)."""
        from ..view.axes import format_time_ticks, REC_TIME, ABS_TIME

        rows = []
        _, units, strs, _ = format_time_ticks([t], 0.001)
        rows.append(("REC", units, strs[0]))
        if self.data.start_time is not None:
            _, units, strs, _ = format_time_ticks(
                [t], 0.001, mode=ABS_TIME, starttime=self.data.start_time,
                add_date=True)
            rows.append(("Time", units, strs[0]))
        if len(self.data.data.file_paths) > 1:
            fp, local = self.data.data.get_file_index(
                int(t * self.data.rate))
            rows.append(("File", str(fp.name), f"{local / self.data.rate:.4f}"))
        return rows

    def hover_readout(self, t, y=None, kind="trace", channel=0):
        """One status-bar line for a hover at (t, y): the per-mode time
        rows plus the amplitude / frequency (+power) under the cursor
        (`src/audian/timeplot.py:154-192`, `spectrogramplot.py` hover)."""
        parts = [f"{label} {value} {unit}".strip()
                 for label, unit, value in self.time_info(t)]
        if y is not None:
            if kind == "spec":
                parts.append(f"f={y:.1f} Hz")
                # resolve through the spectrogram trace's own panel —
                # plugin chains may name it something other than
                # "spectrogram" (`databrowser.py:243-245` routing)
                panel = None
                if self.panels is not None and self.spectrogram in self.data:
                    panel = self.panels.get(
                        self.data[self.spectrogram].panel)
                power = (panel.get_power(channel, t, y)
                         if panel is not None and len(panel) > channel
                         else None)
                if power is not None:
                    parts.append(f"{power:.1f} dB")
            else:
                parts.append(f"a={y:.4g}")
        return " | ".join(parts)

    # -- regions ------------------------------------------------------------------

    def analyze(self, t0, t1, channel):
        """Run all analyzers over the selected region
        (`databrowser.py:1759-1774`)."""
        traces = self.data.get_region(t0, t1, channel)
        for a in self.analyzers:
            a.analyze(t0, t1, channel, traces)
        self.sigAnalysisChanged.emit()
        return traces

    def analyze_region(self, t0, t1, channel):
        """Reference-named alias of :meth:`analyze`
        (`databrowser.py:1759`)."""
        return self.analyze(t0, t1, channel)

    def save_region(self, t0, t1, file_path=None):
        """Export the selected region to a WAV with shifted start time,
        coding history, and the contained markers
        (`databrowser.py:1860-1921`)."""
        rate = self.data.rate
        i0 = max(int(np.round(t0 * rate)), 0)
        i1 = min(int(np.round(t1 * rate)), len(self.data.data))
        t0 = i0 / rate
        name = Path(self.data.file_path).stem
        if file_path is None:
            file_path = Path(self.data.file_path).with_name(
                f"{name}-{secs_to_str(t0)}-{secs_to_str(i1 / rate)}.wav")
        md = deepcopy(self.data.meta_data)
        md.pop("Format", None)
        wavio.update_starttime(md, t0, rate)
        encoding = self.data.data.encoding
        to_flac = str(file_path).lower().endswith(".flac")
        # preserve the source depth: a FLAC_24 recording saves as
        # PCM_24, not a silent 16-bit quantization (reference: region
        # export at source depth via libsndfile, databrowser.py:1860);
        # depths without a WAV/FLAC integer encoding round up
        if encoding.upper().startswith("FLAC_"):
            depth = int(encoding.split("_", 1)[1])
            encoding = ("PCM_16" if depth <= 16 else
                        "PCM_24" if depth <= 24 else "PCM_32")
        if to_flac and encoding.upper() in ("FLOAT", "DOUBLE"):
            # FLAC is integer-only: a float recording exported to a
            # .flac target quantizes at 24 bits (the full f32 mantissa;
            # write_audio itself refuses float encodings loudly so the
            # depth choice stays an explicit caller decision)
            encoding = "PCM_24"
        # validate against the TARGET format's encodings (a WAV-only
        # encoding like PCM_U8 must not leak into a .flac export)
        if encoding not in wavio.available_encodings(
                "FLAC" if to_flac else "WAV"):
            encoding = "PCM_16"
        hkey = "CodingHistory"
        if "BEXT" in md:
            hkey = "BEXT.CodingHistory"
        # the history line describes the file being WRITTEN: post-remap
        # encoding, the selected channel count — not the source
        bext_code = wavio.bext_history_str(encoding, rate,
                                           len(self.selected_channels))
        wavio.add_history(
            md,
            bext_code + f",T=cut out {secs_to_str(t0)}-"
            f"{secs_to_str(i1 / rate)}: {Path(file_path).name}",
            hkey,
            wavio.bext_history_str(self.data.data.encoding, rate,
                                   self.data.channels)
            + f",T={self.data.file_path}",
        )
        locs, labels = self.marker_data.get_markers(rate)
        if len(locs):
            sel = (locs[:, 0] + locs[:, 1] >= i0) & (locs[:, 0] <= i1)
            locs = locs[sel].copy()
            labels = labels[sel]
            locs[:, 0] -= i0
            # clamp spans into the cut: markers straddling the region
            # start begin at 0 with their length reduced, and lengths
            # stop at the cut end — the WAV cue/ltxt chunks pack
            # unsigned ints, so negative values would crash the export
            # (the reference sidesteps this by writing the positions
            # unshifted, `databrowser.py:1899-1902`)
            head = locs[:, 0] < 0
            locs[head, 1] = np.maximum(locs[head, 1] + locs[head, 0], 0)
            locs[head, 0] = 0
            locs[:, 1] = np.clip(locs[:, 1], 0, (i1 - i0) - locs[:, 0])
        raw = np.asarray(self.data.data[i0:i1, self.selected_channels])
        wavio.write_audio(file_path, raw, rate, metadata=md, locs=locs,
                          labels=labels, encoding=encoding)
        self.save_path = Path(file_path).parent
        return Path(file_path)

    # -- render tiles (GUI pull interface) --------------------------------------------

    @property
    def device_state(self):
        """``"ok"`` or ``"lost"`` — the device watchdog's view of the
        device.  While lost, windows come from the host scipy path
        (`Data._host_windows`); both frontends render a
        "device lost — host mode" notice from this."""
        return "lost" if _devwatch.lost else "ok"

    def device_status_text(self):
        """Status-line text for the frontends; empty when healthy."""
        return "device lost — host mode" if _devwatch.lost else ""

    def poll_device_state(self):
        """Fold watchdog state flips into the session (frontends call
        this on their redraw path — watchdog threads only flip flags,
        they never touch GUI objects).  On recovery, recomputes the
        visible windows on the device so the next render leaves host
        mode automatically.  Returns the current state string."""
        lost = _devwatch.lost
        if not lost and self.data is not None and self.data._host_mode:
            # device is back but the windows still hold host-mode
            # content: re-run the window update — numpy windows reject
            # the delta path, so this re-uploads and recomputes on
            # device, restoring full speed without user action
            self.set_times()
        return "lost" if lost else "ok"

    def trace_tile(self, name, channel, t0=None, t1=None):
        if t0 is None:
            t0, t1 = self.toffset, self.toffset + self.twindow
        return self.trace_tiler.tile(self.data[name], t0, t1, channel)

    def spec_tile(self, channel, zmin=None, zmax=None, quantize=False):
        trace = self.data[self.spectrogram] if self.spectrogram else None
        if trace is None:
            return np.zeros((0, 0)), (0.0, 0.0, 0.0, 0.0)
        # the visible span bounds a mid-tile device loss's host
        # recompute (the tile itself still covers the whole window)
        vis = (self.toffset, self.toffset + self.twindow)
        buf = trace.buffer
        if buf is None or len(buf) == 0:
            return self.spec_tiler.tile(trace, channel, zmin or -100.0,
                                        zmax or 0.0, quantize=quantize,
                                        loss_span=vis)
        # full per-channel level vector (cheap via the cached device
        # stats) so the tiler can serve every channel from one batched
        # device pull; explicit levels override the requested channel
        levels = np.array([self.estimate_power_levels(c)
                           for c in range(buf.shape[1])], np.float32)
        if zmin is not None:
            levels[channel, 0] = zmin
        if zmax is not None:
            levels[channel, 1] = zmax
        return self.spec_tiler.tile(trace, channel, levels[channel, 0],
                                    levels[channel, 1], quantize=quantize,
                                    levels=levels, loss_span=vis)

    def power_spectrum(self, channel, t0=None, t1=None):
        """Mean power spectrum (dB) over the visible window — the data
        behind the reference's per-spectrogram power side plot
        (`src/audian/spectrogramplot.py:144-164`).

        Returns ``(freqs, dB)``.
        """
        trace = self.data[self.spectrogram] if self.spectrogram else None
        if trace is None:
            return np.zeros(0), np.zeros(0)
        if t0 is None:
            t0, t1 = self.toffset, self.toffset + self.twindow
        i0 = max(int(t0 * trace.rate) - trace.offset, 0)
        i1 = min(int(t1 * trace.rate + 1) - trace.offset, len(trace.buffer))
        if i1 <= i0:
            return trace.frequencies, np.full(trace.spec.more_shape[0],
                                              -np.inf)
        buf = trace.buffer
        if isinstance(buf, jax.Array):
            # device reduction with a bucketed slice: only one dB row
            # crosses the host link, and a handful of compiled widths
            # serve every window
            width = i1 - i0
            wb = min(1 << max(width - 1, 0).bit_length(), len(buf))
            start = max(min(i0, len(buf) - wb), 0)
            try:
                db = _devwatch.pull(
                    lambda: np.asarray(mean_power_db_slice(
                        buf, start, channel, i0 - start, width, wb)),
                    what="power spectrum")
            except DeviceLost:
                self.data._host_windows(targets=[trace._node.name])
                buf = trace.buffer
                if isinstance(buf, jax.Array):
                    raise  # host recompute could not produce the window
                mean = np.asarray(buf[i0:i1, channel, :]).mean(axis=0)
                db = 10 * np.log10(np.maximum(mean, 1e-20))
        else:
            mean = np.asarray(buf[i0:i1, channel, :]).mean(axis=0)
            db = 10 * np.log10(np.maximum(mean, 1e-20))
        return trace.frequencies, db

    def estimate_power_levels(self, channel):
        """Noise-floor based auto color levels
        (`src/audian/bufferedspectrogram.py:109-126` via
        `plotranges.py:461-478`)."""
        trace = self.data[self.spectrogram] if self.spectrogram else None
        buf = trace.buffer if trace is not None else None
        if buf is None or buf.size == 0:
            return (-100.0, 0.0)
        node = trace._node
        nf = max(buf.shape[2] // 16, 1)
        # all-channel reduction, cached STICKY per content epoch — on
        # device because the naive route pulls the whole ~200 MB
        # spectrogram window to the host per channel, and in host mode because per-call re-leveling
        # is O(window) log passes per redraw AND shifting zmin/zmax per
        # window would invalidate the spec tile delta cache every slide.
        # Sticky = the reference's "first-time auto color levels"
        # semantics (`plotranges.py:461-478`): scrolling keeps the
        # levels, a parameter change (epoch bump) re-estimates.
        import weakref

        epoch = trace.content_epoch
        cached = self._power_level_stats
        key = (id(trace), trace.nfft, epoch)
        if cached is None or cached[0] != key \
                or cached[3]() is not trace or (
                epoch is None and cached[1]() is not buf):
            if isinstance(buf, jax.Array):
                try:
                    stats = _devwatch.pull(
                        lambda: np.asarray(noise_level_stats(buf, nf)),
                        what="noise levels")
                except DeviceLost:
                    self.data._host_windows(targets=[trace._node.name])
                    if isinstance(trace.buffer, jax.Array):
                        raise  # pragma: no cover - host recompute failed
                    return self.estimate_power_levels(channel)
                _trace.trace_event("render.pull", op="noise_levels",
                                   bytes=stats.nbytes)
            else:
                stats = host_noise_level_stats(np.asarray(buf), nf)
            # weak refs: a strong one would pin the superseded
            # spectrogram window (~200 MB) on the device; the trace
            # ref guards the recycled-id case (id(trace) in the key)
            cached = (key, weakref.ref(buf), stats,
                      weakref.ref(trace))
            self._power_level_stats = cached
        db_tail, db_all = cached[2][channel]
        zmin, zmax = node.estimate_noiselevels(db_tail, db_all)
        if zmin is None:
            return (-100.0, 0.0)
        return zmin, zmax


# background NFFT-warm threads still alive at interpreter exit: join
# them BEFORE finalization (a daemon thread force-killed inside an XLA
# call aborts the process with "FATAL: exception not rethrown"); the
# warm loops poll their browser's _closed flag, so each survivor ends
# after at most its in-flight bucket compile
import atexit as _atexit
import threading as _threading
import weakref as _weakref

_live_warm_threads = _weakref.WeakSet()
#: set at interpreter exit: every warm loop polls it (alongside its
#: browser's _closed), so unclosed sessions' sweeps also stop after
#: their in-flight bucket instead of outliving the 120 s join
_warm_stop = _threading.Event()


def _join_warm_threads():
    _warm_stop.set()
    for th in list(_live_warm_threads):
        if th.is_alive() and th is not _threading.current_thread():
            th.join(120.0)


_atexit.register(_join_warm_threads)
