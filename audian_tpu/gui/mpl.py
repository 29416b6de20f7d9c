"""Matplotlib frontend.

A complete keyboard-driven browser over the headless controllers — the
same role the reference's PyQt5/pyqtgraph window plays
(`src/audian/databrowser.py`, `src/audian/audian.py`), with the view
composed of per-channel trace + spectrogram panels above a whole-recording
overview (`src/audian/fulltraceplot.py` analog).  All pixels come from the
device render tiles (:mod:`audian_tpu.view.render`); matplotlib only blits
them.  Runs under any matplotlib backend, including Agg for headless
screenshots; the richer Qt/pyqtgraph frontend lives in
:mod:`audian_tpu.gui.qt`.

Key bindings (subset of the reference's ~60 actions, same keys):
    right/left . ,                x/X zoom in/out (time)
    home/end                      f/F highpass up/down  l/L lowpass
    e/E envelope cutoff           r/R frequency resolution (NFFT)
    p play visible window         s save screenshot
    o zoom / y play / a analyze / w save-region  (rect-selection mode)
    b/B zoom history back/forward
    m set marker at crosshair     q quit
    t cycle time-axis label mode (recording / absolute / per-file)
    c toggle color bars           z toggle power side plots
    C cycle color map             g cycle grid mask
    up/down previous/next channel pageup/pagedown extend selection
    1..9,0 show only that channel (again restores all)
    ! auto-scroll faster          space play / stop

Mouse: drag a rectangle on any panel to apply the current region mode
(zoom / play / analyze / save, `src/audian/databrowser.py:1614-1642`);
click a panel to place the crosshair with time/amplitude/frequency
readouts; click the overview to jump there
(`src/audian/fulltraceplot.py:208-224`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..app.browser import DataBrowser
from ..app.screenshot import save_view_screenshot
from ..view.zoom import Rect, ZoomHistory, SelectionModel
from ..view.render import pick_amplitude

__all__ = ["MplBrowserWindow", "show"]

# nearest matplotlib equivalents of the reference's colorcet maps
# (`src/audian/databrowser.py:53-65`)
CET_TO_MPL = {"CET-R4": "turbo", "CET-L8": "plasma", "CET-L16": "viridis",
              "CET-CBL2": "cividis", "CET-L1": "gray", "CET-L3": "inferno"}


class MplBrowserWindow:
    """One figure per recording: overview + per-channel panels."""

    def __init__(self, browser: DataBrowser, figsize=(12, 8), show_spec=True):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.browser = browser
        # gate on the browser's RESOLVED spectrogram trace name —
        # plugin presets may name it something other than "spectrogram"
        # (the Qt frontend already resolves it this way)
        self.show_spec = show_spec and browser.spectrogram in browser.data
        self.fig = plt.figure(figsize=figsize)
        self._artists = {}  # persistent per-axes artists (see _ax_artists)
        self._built_channels = None
        self._build_axes(list(browser.show_channels))
        # interactive backends pre-connect matplotlib's default key
        # handler (fullscreen on 'f', log-scale on 'l', save dialog on
        # 's', toolbar pan/zoom on 'o'/'p', ...) — it would fire on top
        # of the browser's key table, so disconnect it
        mgr = getattr(self.fig.canvas, "manager", None)
        kid = getattr(mgr, "key_press_handler_id", None)
        if kid is not None:
            self.fig.canvas.mpl_disconnect(kid)
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.on_press)
        self.fig.canvas.mpl_connect("button_release_event", self.on_release)
        self.fig.canvas.mpl_connect("motion_notify_event", self.on_motion)
        self.fig.canvas.mpl_connect("close_event", self._on_close)
        self.region_mode = "zoom"  # zoom | play | analyze | save
        self.zoom_history = ZoomHistory()
        self.zoom_history.init(Rect(browser.toffset, 0,
                                    browser.toffset + browser.twindow, 1))
        self._selection = None
        self._press_ax = None
        self.crosshair = None  # (channel, t, y, panel_kind)
        self.status = ""
        #: time-axis label mode, cycled with 't'
        #: (`src/audian/timeaxisitem.py:20-26`)
        self.starttime_mode = 0
        # hover readout line (`src/audian/timeplot.py:154-192`)
        self.hover_text = self.fig.text(0.01, 0.002, "", fontsize=8,
                                        family="monospace")
        self._hover_drawn = 0.0
        # 50 ms auto-scroll / audio-position ticks — the mpl analog of
        # the reference's QTimer (`databrowser.py:1659-1680,1745-1756`)
        self.timer = self.fig.canvas.new_timer(interval=50)
        self.timer.add_callback(self._tick)
        self._audio_t = None
        # linked updates from other windows redraw this one too
        # (`audian.py:597-612` keeps all open files in sync); pairs are
        # kept so _on_close can disconnect — a closed window must not
        # keep pulling device tiles for linked updates
        self._conns = []
        for sig in (browser.sigFilterChanged, browser.sigEnvelopeChanged,
                    browser.sigResolutionChanged, browser.sigColorMapChanged,
                    browser.sigPanelsChanged):
            sig.connect(self._linked_redraw)
            self._conns.append((sig, self._linked_redraw))
        for sig in (browser.sigTimesChanged, browser.sigChannelsChanged):
            slot = lambda *a: self._linked_redraw()
            sig.connect(slot)
            self._conns.append((sig, slot))
        self._in_redraw = False
        self._closed = False
        self._redraw_serial = 0
        self.redraw()

    def _build_axes(self, channels):
        """(Re)build the per-channel subplot grid.  Called at open and
        whenever the shown-channel set changes — the headless channel
        verbs can grow or scroll it past the construction-time set."""
        for ax in list(self.fig.axes):
            ax.remove()
        self._artists = {}
        # a thin spacer row keeps the bottom data panel's time label
        # clear of the overview strip
        rows = len(channels) * (2 if self.show_spec else 1) + 2
        # trace rows shrink relative to the spectrograms as the
        # show_specs level grows (`databrowser.py:118,1050-1052`); at
        # level 0 the hidden spectrogram rows collapse to (near) zero
        # height so the traces get the figure back
        b = self.browser
        frac = b.trace_fracs.get(b.show_specs, 1) if self.show_spec else 1
        spec_h = 2 if b.show_specs > 0 else 0.001
        heights = (([max(2 * frac, 0.3), spec_h] if self.show_spec else [3])
                   * len(channels) + [0.25, 1])
        self._built_spec_level = b.show_specs if self.show_spec else None
        # three columns: panels | color bars | power side plots
        # (`src/audian/spectrogramplot.py:87-92,144-164`)
        gs = self.fig.add_gridspec(rows, 3, width_ratios=[24, 0.7, 5],
                                   height_ratios=heights, hspace=0.35,
                                   wspace=0.08)
        self.trace_axs = {}
        self.spec_axs = {}
        self.cbar_axs = {}
        self.power_axs = {}
        k = 0
        for c in channels:
            self.trace_axs[c] = self.fig.add_subplot(gs[k, 0])
            k += 1
            if self.show_spec:
                self.spec_axs[c] = self.fig.add_subplot(gs[k, 0])
                self.cbar_axs[c] = self.fig.add_subplot(gs[k, 1])
                self.power_axs[c] = self.fig.add_subplot(gs[k, 2])
                k += 1
        self.overview_ax = self.fig.add_subplot(gs[rows - 1, :])
        self._built_channels = list(channels)

    def _linked_redraw(self):
        if not self._in_redraw and not self._closed:
            self.redraw()

    def close(self):
        """Tear down and close the figure.  Agg never emits close_event
        from ``plt.close``, so 'q' routes through here; window-manager
        closes on GUI backends arrive via the close_event hook."""
        self._on_close()
        self.plt.close(self.fig)

    def _on_close(self, *args):
        """Figure closed (q / window button): stop the timer and detach
        from the browser so linked updates from other windows stop
        redrawing a dead canvas."""
        self._closed = True
        try:
            self.timer.stop()
        except Exception:
            pass
        for sig, slot in self._conns:
            try:
                sig.disconnect(slot)
            except ValueError:
                pass
        self._conns = []

    def _axis_channel(self, ax):
        """(kind, channel) of a clicked axes."""
        for c, a in self.trace_axs.items():
            if a is ax:
                return "trace", c
        for c, a in self.spec_axs.items():
            if a is ax:
                return "spec", c
        if ax is self.overview_ax:
            return "overview", self.browser.show_channels[0]
        return None, None

    # -- mouse ---------------------------------------------------------------------

    def _toolbar_busy(self):
        """True while the backend toolbar's pan/zoom mode is armed — its
        drags must not double as region selections."""
        toolbar = getattr(self.fig.canvas, "toolbar", None)
        return bool(toolbar is not None and getattr(toolbar, "mode", ""))

    def on_press(self, event):
        # only plain left-button presses select; real backends deliver
        # right/middle buttons through the same event
        if getattr(event, "button", 1) not in (1, None):
            return
        if self._toolbar_busy():
            return
        if event.inaxes is None or event.xdata is None:
            return
        kind, channel = self._axis_channel(event.inaxes)
        if kind == "overview":
            # jump the view window to the clicked time
            b = self.browser
            serial = self._redraw_serial
            b.set_times(event.xdata - b.twindow / 2)
            if serial == self._redraw_serial:  # signal didn't redraw
                self.redraw()
            return
        if kind is None:
            return
        self._press_ax = event.inaxes
        self._selection = SelectionModel(channel, view=kind,
                                         on_selected=self._region_selected)
        self._selection.begin(event.xdata, event.ydata)

    def on_release(self, event):
        sel = self._selection
        self._selection = None
        if sel is None:
            return
        ax = self._press_ax
        self._press_ax = None
        if event.inaxes is ax and event.xdata is not None:
            x, y = event.xdata, event.ydata
        elif ax is not None:
            # released outside the press axes (or the figure): project
            # the pixel position into the press panel's data coordinates
            # and clamp to its view — dragging past the edge zooms to
            # the border instead of silently dropping the selection
            x, y = ax.transData.inverted().transform((event.x, event.y))
        else:
            return
        x0, x1 = sorted(ax.get_xlim())
        y0, y1 = sorted(ax.get_ylim())
        x = min(max(x, x0), x1)
        y = min(max(y, y0), y1)
        rect = Rect(sel.anchor[0], sel.anchor[1], x, y).normalized()
        # small drags count as clicks: place the crosshair
        if rect.right() - rect.left() < 1e-3 * self.browser.twindow:
            self._set_crosshair(sel.view, sel.channel, x, y)
            self.redraw()
            return
        sel.finish(x, y)

    def _set_crosshair(self, kind, channel, t, y):
        """Crosshair with snap-to-extremum on traces and power readout on
        spectrograms (`src/audian/timeplot.py:126-146`,
        `src/audian/spectrogramplot.py` hover semantics)."""
        b = self.browser
        if kind == "trace":
            name = "filtered" if "filtered" in b.data else "data"
            step_t = b.twindow / 1920
            t, y = pick_amplitude(b.data[name], t, y, t + step_t, channel)
            self.status = f"ch{channel}  t={t:.4f}s  a={y:.4f}"
            b.set_crosshair(channel, t=t, amplitude=y)
        else:
            self.status = f"ch{channel}  t={t:.4f}s  f={y:.0f}Hz"
            b.set_crosshair(channel, t=t, frequency=y)
        # delta readouts vs the stored marker (`plotranges.py:616-660`)
        info = b.crosshair_readout()
        deltas = [f"Δ{key[6:]}={info[key]:.6g}"
                  for key in ("delta_time", "delta_amplitude",
                              "delta_frequency", "delta_power")
                  if info.get(key) is not None]
        if deltas:
            self.status += "  " + "  ".join(deltas)
        self.crosshair = (channel, t, y, kind)

    def _browser_crosshair(self):
        """The crosshair as the headless browser knows it — the single
        source of truth, so placements through ``browser.set_crosshair``
        render identically to clicks."""
        pr = self.browser.plot_ranges
        t = pr.marker_time()[1]
        if t is None:
            return None
        channel = next((pr[s].marker_channel for s in "txyufwpq"
                        if pr[s].marker_channel is not None), 0)
        freq = pr.marker_frequency()[1]
        if freq is not None:
            return (channel, t, freq, "spec")
        return (channel, t, pr.marker_amplitude()[1], "trace")

    def on_motion(self, event):
        """Hover readout: the per-mode time rows plus the hovered value
        (`src/audian/timeplot.py:154-192`,
        `src/audian/fulltraceplot.py:253-287`)."""
        if event.inaxes is None or event.xdata is None \
                or self._selection is not None:
            return
        kind, channel = self._axis_channel(event.inaxes)
        if kind is None:
            return
        text = self.browser.hover_readout(event.xdata, event.ydata,
                                          kind, channel)
        # the readout embeds sub-second times so it changes on nearly
        # every pixel of motion — rate-limit the (full-figure) repaint to
        # 10 Hz or hovering crawls on slow hosts
        if text != self.hover_text.get_text():
            import time

            self.hover_text.set_text(text)
            now = time.monotonic()
            if now - self._hover_drawn > 0.1:
                self._hover_drawn = now
                self.fig.canvas.draw_idle()
            else:
                self._arm_hover_flush()

    def _arm_hover_flush(self):
        """Trailing-edge flush for the hover throttle: when the mouse
        stops INSIDE the 10 Hz window, a one-shot backend timer repaints
        the last readout — otherwise it stays up to ~100 ms stale until
        some unrelated redraw."""
        if getattr(self, "_hover_timer", None) is not None:
            return
        try:
            tm = self.fig.canvas.new_timer(interval=120)
            tm.single_shot = True
        except Exception:
            return  # backend without timers: throttle-only behavior

        def flush():
            import time

            self._hover_timer = None
            self._hover_drawn = time.monotonic()
            self.fig.canvas.draw_idle()

        tm.add_callback(flush)
        tm.start()
        self._hover_timer = tm

    # string ↔ DataBrowser region-mode constants
    _mode_consts = {"zoom": DataBrowser.zoom_region,
                    "play": DataBrowser.play_region_mode,
                    "analyze": DataBrowser.analyze_region_mode,
                    "save": DataBrowser.save_region_mode,
                    "ask": DataBrowser.ask_region}

    def _region_selected(self, channel, kind, rect):
        """Dispatch the selected rectangle to the current region mode via
        the headless controller (`src/audian/databrowser.py:1614-1642`)."""
        b = self.browser
        t0, t1 = rect.left(), rect.right()
        mode = self._mode_consts.get(self.region_mode, DataBrowser.zoom_region)
        if mode == DataBrowser.zoom_region:
            self.zoom_history.add(rect)
        serial = self._redraw_serial
        verb, result = b.handle_region(channel, t0, t1, mode)
        if verb == "play":
            self._play(*result)
        elif verb == "analyze":
            rows = [f"{a.name}: {a.data.formatted(-1)}"
                    for a in b.analyzers if len(a.data)]
            self.status = " | ".join(rows)[:120]
            print(self.status)
        elif verb == "save":
            self.status = f"saved region to {result}"
            print(self.status)
        if serial == self._redraw_serial:  # no signal-driven redraw ran
            self.redraw()

    # -- drawing ------------------------------------------------------------------

    def redraw(self):
        if self._in_redraw:
            return
        self._in_redraw = True
        try:
            self._redraw()
        finally:
            self._in_redraw = False

    def _ax_artists(self, kind, c, ax):
        """Persistent artists per axes — ``ax.clear()`` + replot costs
        ~100 ms of tick/spine reconstruction per axes, so redraws only
        push new data into existing Line2D/AxesImage objects."""
        art = self._artists.get((kind, c))
        if art is not None:
            return art
        from matplotlib.collections import LineCollection

        # the cursor/playback lines sit ABOVE the data artists
        # (zorder > the event scatters' 5): a dense min/max waveform can
        # fill the whole panel and would otherwise paint over them
        art = {
            "cx": ax.axvline(0.0, color="#cccc00", lw=0.8, visible=False,
                             zorder=6),
            "cy": ax.axhline(0.0, color="#cccc00", lw=0.8, visible=False,
                             zorder=6),
            # playback position marker, driven by the 50 ms tick
            # (`databrowser.py:1745-1756`)
            "audio": ax.axvline(0.0, color="m", lw=1.0, visible=False,
                                zorder=6),
        }
        if kind == "trace":
            art["trace"] = ax.plot([], [], lw=0.6)[0]
            art["env"] = ax.plot([], [], lw=1.2, visible=False)[0]
            art["marks"] = LineCollection(
                [], colors="yellow", lw=0.8, alpha=0.7,
                transform=ax.get_xaxis_transform())
            ax.add_collection(art["marks"])
            art["events"] = ax.scatter([], [], s=16, zorder=5)
            ax.set_ylabel(f"ch {c}")
        else:
            art["im"] = ax.imshow(np.zeros((1, 1)), origin="lower",
                                  aspect="auto", interpolation="nearest",
                                  vmin=0, vmax=255, extent=(0, 1, 0, 1),
                                  visible=False)
            art["events"] = ax.scatter([], [], s=16, zorder=5)
            ax.set_ylabel("f/Hz")
        self._artists[(kind, c)] = art
        return art

    def _set_event_offsets(self, scatter, channel, panel):
        """Fill one panel's analyzer-event scatter with the events whose
        resolved owner (`EventRecorder.owner_panel`) matches ``panel``."""
        b = self.browser
        xs, ys, cols = [], [], []
        for a, name, rec in b.iter_event_items():
            if rec.channel != channel or not len(rec.x):
                continue
            owner = rec.owner_panel(b)
            if (owner == "spectrogram") != (panel == "spectrogram"):
                continue
            xs.extend(rec.x)
            ys.extend(rec.y)
            cols.extend([rec.color or "red"] * len(rec.x))
        scatter.set_offsets(
            np.column_stack([xs, ys]) if xs else np.empty((0, 2)))
        if cols:
            scatter.set_color(cols)

    def _redraw(self):
        b = self.browser
        self._redraw_serial += 1
        # fold device-loss flips in on the draw path (watchdog threads
        # only set flags); the note itself joins the title suptitle
        # below (a second suptitle would just be overwritten)
        b.poll_device_state()
        # channel verbs can grow/scroll the shown set beyond the built
        # axes — rebuild the grid when it changes, or when the
        # show_specs level moved the trace/spec height split (level 0
        # included: it collapses the spec rows and restores the traces)
        if (list(b.show_channels) != self._built_channels
                or (self.show_spec
                    and b.show_specs != self._built_spec_level)):
            self._build_axes(list(b.show_channels))
        t0, t1 = b.toffset, b.toffset + b.twindow
        name = "filtered" if "filtered" in b.data else "data"
        # visibility pre-pass: _bottom_data_ax (the single time-label
        # carrier) must see THIS frame's layout before either panel loop
        # formats its axis
        for c, ax in self.trace_axs.items():
            ax.set_visible(c in b.show_channels and b.show_traces)
        for c, ax in self.spec_axs.items():
            ax.set_visible(c in b.show_channels and b.show_specs > 0)
        for c, ax in self.trace_axs.items():
            if not ax.get_visible():
                continue
            art = self._ax_artists("trace", c, ax)
            times, values = b.trace_tile(name, c)
            art["trace"].set_data(times, values)
            art["trace"].set_color(b.data[name].color if name != "data"
                                   else "#0000ee")
            env_on = "envelope" in b.data and b.data.is_visible("envelope")
            art["env"].set_visible(env_on)
            if env_on:
                art["env"].set_data(*b.trace_tile("envelope", c))
                art["env"].set_color(b.data["envelope"].color)
            # markers (`markerdata.py` events shown on the traces)
            art["marks"].set_segments(
                [((tm, 0.0), (tm, 1.0))
                 for tm, ch in zip(b.marker_data.times,
                                   b.marker_data.channels)
                 if t0 <= tm <= t1 and (ch == c or ch < 0)])
            # analyzer event markers owned by this channel's trace panel
            self._set_event_offsets(art["events"], c, "trace")
            ax.set_xlim(t0, t1)
            self._format_time_axis(ax, t0, t1)
            lo, hi = b.get_range("x", c)
            if lo is not None and hi is not None and hi > lo:
                ax.set_ylim(lo, hi)
        for c, ax in self.spec_axs.items():
            if not ax.get_visible():
                for side in (self.cbar_axs.get(c), self.power_axs.get(c)):
                    if side is not None:
                        side.set_visible(False)
                continue
            art = self._ax_artists("spec", c, ax)
            # auto levels come from the browser's per-window cached
            # stats (pinning a first-redraw snapshot here would make the
            # per-channel level vectors diverge and defeat the batched
            # all-channel tile pull); u8 tiles: 4x fewer pulled bytes
            img, rect = b.spec_tile(c, quantize=True)
            art["im"].set_visible(bool(img.size))
            if img.size:
                art["im"].set_data(img.T)
                # rect is (x, y, w, h) — the same contract the Qt
                # frontend's QRectF consumes
                art["im"].set_extent((rect[0], rect[0] + rect[2],
                                      rect[1], rect[1] + rect[3]))
                art["im"].set_cmap(CET_TO_MPL.get(b.color_map_name,
                                                  "magma"))
            self._set_event_offsets(art["events"], c, "spectrogram")
            ax.set_xlim(t0, t1)
            self._format_time_axis(ax, t0, t1)
            self._draw_cbar(c, art)
            self._draw_power(c, t0, t1)
        # the headless browser is the source of truth for the crosshair —
        # placements through browser.set_crosshair render without a click
        self.crosshair = self._browser_crosshair()
        for key, art in self._artists.items():
            if not isinstance(key, tuple) or "cx" not in art:
                continue
            kind, c = key
            on = (self.crosshair is not None
                  and self.crosshair[3] == kind and self.crosshair[0] == c)
            art["cx"].set_visible(on)
            art["cy"].set_visible(on and self.crosshair[2] is not None)
            if on:
                art["cx"].set_xdata([self.crosshair[1]] * 2)
                if self.crosshair[2] is not None:
                    art["cy"].set_ydata([self.crosshair[2]] * 2)
            audio_on = self._audio_t is not None and kind == "trace"
            art["audio"].set_visible(audio_on)
            if audio_on:
                art["audio"].set_xdata([self._audio_t] * 2)
        # selected channels carry an emphasized panel border
        # (`databrowser.py:367,969-974`); the grid mask is re-applied on
        # every pass so it reflects browser state and survives grid
        # rebuilds (channel/spec-level changes recreate the axes)
        sel = set(b.selected_channels)
        for axs in (self.trace_axs, self.spec_axs):
            for c, ax in axs.items():
                # mpl enables the grid whenever style kwargs are passed,
                # so the off case must not carry alpha
                for axis, bit in (("x", 1), ("y", 2)):
                    if b.grids & bit:
                        ax.grid(True, axis=axis, alpha=0.4)
                    else:
                        ax.grid(False, axis=axis)
                for spine in ax.spines.values():
                    spine.set_edgecolor("#888888" if c in sel else "black")
                    spine.set_linewidth(2.0 if c in sel else 0.8)
        self._draw_overview()
        title = Path(str(b.data.file_path)).name
        f = b.data["filtered"]
        if f is not None and f.design is not None:
            title += (f"   [{f.highpass_cutoff:.0f}-"
                      f"{f.lowpass_cutoff:.0f} Hz]")
        title += f"   mode:{self.region_mode}"
        dev_note = b.device_status_text()
        if dev_note:
            title += f"   !! {dev_note} !!"
        if self.status:
            title += f"\n{self.status}"
        kw = {"color": "#cc2200"} if dev_note else {}
        self.fig.suptitle(title, fontsize=10, **kw)
        self.fig.canvas.draw_idle()

    def _bottom_data_ax(self):
        """The lowest visible data panel — the only one carrying the
        time-axis label (stacked panels share ticks; repeating the label
        under every panel collides with the panel below)."""
        best = None
        for ax in (list(self.trace_axs.values())
                   + list(self.spec_axs.values())):
            if not ax.get_visible():
                continue
            if best is None or ax.get_position().y0 < best.get_position().y0:
                best = ax
        return best

    def _format_time_axis(self, ax, t0, t1):
        """Tick the time axis through :mod:`audian_tpu.view.axes`: the
        width-aware 1/2/5 spacing and the current start-time label mode
        (`src/audian/timeaxisitem.py:60-206`)."""
        from ..view.axes import tick_spacing, format_time_ticks

        width_px = self.fig.get_size_inches()[0] * self.fig.dpi
        span = tick_spacing(t0, t1, width_px, 80.0)
        if span is None:
            return
        major = span[0]
        ticks = np.arange(np.ceil(t0 / major) * major, t1 + 0.5 * major,
                          major)
        data = self.browser.data
        try:
            file_times = data.data.file_start_times()
            file_paths = [Path(p).name for p in data.data.file_paths]
        except AttributeError:
            file_times, file_paths = None, None
        label, units, strings, filename = format_time_ticks(
            ticks, major, mode=self.starttime_mode,
            starttime=data.start_time, file_times=file_times,
            file_paths=file_paths)
        ax.set_xticks(ticks)
        if ax is not self._bottom_data_ax():
            # only the bottom data panel shows tick values and the axis
            # label; the stacked panels above keep bare tick marks
            # (`databrowser.py:994-1008`)
            ax.set_xticklabels([""] * len(ticks))
            ax.set_xlabel("")
            return
        ax.set_xticklabels(strings)
        text = label or "time"
        if label == "File" and filename:
            text = f"File {filename}"
        ax.set_xlabel(f"{text} ({units})" if units else text)

    def _draw_cbar(self, c, art):
        """Color bar per spectrogram honoring toggle_colorbars
        (`src/audian/spectrogramplot.py:87-92`); the u8 image maps the
        [zmin, zmax] dB levels onto 0..255."""
        b = self.browser
        cax = self.cbar_axs.get(c)
        if cax is None:
            return
        on = b.show_cbars and b.show_specs > 0 and c in b.show_channels
        cax.set_visible(on)
        if not on:
            return
        if art.get("cbar") is None:
            art["cbar"] = self.fig.colorbar(art["im"], cax=cax)
        else:
            art["cbar"].update_normal(art["im"])
        zmin, zmax = b.get_range("p", c)
        if zmin is not None and zmax is not None and zmax > zmin:
            ticks = np.linspace(0.0, 255.0, 5)
            cax.set_yticks(ticks)
            cax.set_yticklabels(
                [f"{zmin + t / 255.0 * (zmax - zmin):.0f}" for t in ticks])
            cax.set_ylabel("dB", fontsize=7)
        cax.tick_params(labelsize=7)

    def _draw_power(self, c, t0, t1):
        """Live mean-power side plot of the visible window
        (`src/audian/spectrogramplot.py:144-164`)."""
        b = self.browser
        pax = self.power_axs.get(c)
        if pax is None:
            return
        on = b.show_powers and b.show_specs > 0 and c in b.show_channels
        pax.set_visible(on)
        if not on:
            return
        art = self._artists.get(("power", c))
        if art is None:
            art = {"line": pax.plot([], [], lw=0.8, color="#00aaaa")[0]}
            pax.tick_params(labelsize=7)
            pax.set_xlabel("dB", fontsize=7)
            self._artists[("power", c)] = art
        freqs, db = b.power_spectrum(c, t0, t1)
        finite = np.isfinite(db)
        art["line"].set_data(np.asarray(db)[finite],
                             np.asarray(freqs)[finite])
        zmin, zmax = b.get_range("p", c)
        if zmin is not None and zmax is not None and zmax > zmin:
            pax.set_xlim(zmin, zmax)
        flo, fhi = b.get_range("f", c)
        if flo is not None and fhi is not None and fhi > flo:
            pax.set_ylim(flo, fhi)

    def _draw_overview(self):
        b = self.browser
        ax = self.overview_ax
        ax.set_visible(b.show_fulldata)
        if not b.show_fulldata:
            return
        art = self._artists.get("overview")
        if art is None:
            art = {"span": ax.axvspan(0.0, 1.0, color="#2255cc", alpha=0.4),
                   "fills": [], "fill_key": None}
            ax.set_xlabel("time/s")
            self._artists["overview"] = art
        ft = b.fulltrace
        channels = list(b.show_channels) or [0]
        # while the background decimator fills ft.datas IN PLACE, the
        # array identity never changes — force refresh until it is done
        busy = ft is not None and ft.is_busy()
        key = (id(ft.datas) if ft is not None and ft.datas is not None
               else None, tuple(channels), busy)
        if busy or key != art["fill_key"]:
            for fill in art["fills"]:
                fill.remove()
            art["fills"] = []
            if key[0] is not None:
                n = len(ft.datas)
                peak = float(np.max(np.abs(ft.datas[:n]))) or 1.0
                scale = 0.45 / peak
                # one band per channel, stacked top-down like the panels
                for k, c in enumerate(channels):
                    base = len(channels) - 1 - k
                    art["fills"].append(ax.fill_between(
                        ft.times[:n],
                        base + scale * ft.datas[0::2, c].repeat(2)[:n],
                        base + scale * ft.datas[1::2, c].repeat(2)[:n],
                        color="#888888", lw=0))
                ax.set_ylim(-0.55, len(channels) - 0.45)
                ax.set_yticks(range(len(channels)))
                ax.set_yticklabels(
                    [f"ch {c}" for c in reversed(channels)], fontsize=7)
            art["fill_key"] = key
        x0, x1 = b.toffset, b.toffset + b.twindow
        art["span"].set_bounds(x0, -0.55, x1 - x0,
                               len(channels) + 0.1)
        ax.set_xlim(0, b.data.frames / b.data.rate)

    # -- interaction --------------------------------------------------------------

    def on_key(self, event):
        b = self.browser
        key = event.key
        if key is None:  # matplotlib delivers None for unmapped keys
            return
        serial = self._redraw_serial
        actions = {
            "right": b.time_page_down,
            ".": b.time_page_down,
            "left": b.time_page_up,
            ",": b.time_page_up,
            "x": b.time_zoom_in,
            "X": b.time_zoom_out,
            "home": b.time_home,
            "end": b.time_end,
        }
        if key in actions:
            actions[key]()
        elif key in "fF":
            # headless verb: 10 Hz lift-off floor, below-10 turn-off,
            # Nyquist clamps — shared with the Qt frontend
            b.step_filter(hp_fac=1.25 if key == "f" else 0.8)
        elif key in "lL":
            b.step_filter(lp_fac=0.8 if key == "l" else 1.25)
        elif key in "eE" and "envelope" in b.data:
            cut = b.data["envelope"].envelope_cutoff
            b.update_envelope(cut * (2.0 if key == "E" else 0.5))
        elif key in "rR" and b.spectrogram in b.data:
            # a step compiles only its own bucket (the sweep warms in
            # the background — warm_resolutions_async); plain 'r'
            # decreases like the reference and the Qt frontend
            # (`audian.py:799-805`)
            if key == "R":
                b.freq_resolution_up()
            else:
                b.freq_resolution_down()
            # snapped to a warmed bucket mid-warm: poll for the swap
            self._update_timer()
        elif key == "p":
            play, rate = b.play_visible()
            self._play(play, rate)
        elif key in ("o", "y", "a", "w"):
            self.region_mode = {"o": "zoom", "y": "play", "a": "analyze",
                                "w": "save"}[key]
            self.status = f"region mode: {self.region_mode}"
        elif key in ("b", "B"):
            rect = (self.zoom_history.back() if key == "b"
                    else self.zoom_history.forward())
            if rect is not None:
                b.set_times(rect.left(), rect.right() - rect.left())
        elif key == "C":
            b.color_map_cycler()
        elif key == "v":
            b.auto_ampl()
        elif key == "V":
            b.apply_ranges("reset", "xyu")
        elif key == "i":
            for level, k, val in b.metadata_rows():
                print("  " * level + (f"{k}:" if val is None
                                      else f"{k}: {val}"))
        elif key == "g":
            b.toggle_grids()  # _redraw applies the mask to every panel
        elif key == "down":
            b.next_channel()
        elif key == "up":
            b.previous_channel()
        elif key == "pagedown":
            b.select_next_channel()
        elif key == "pageup":
            b.select_previous_channel()
        elif key is not None and len(key) == 1 and key.isdigit():
            # digit c toggles channel c — 0-based and toggle semantics
            # like the reference's and the Qt frontend's bare digits
            b.toggle_channel(int(key))
        elif key == "!":
            b.auto_scroll()
            self._update_timer()
        elif key == " ":
            verb, result = b.play_scroll()
            if verb == "play":
                self._play(*result)
            elif verb == "audio-stopped":
                self._stop_audio()
            self._update_timer()
        elif key == "m" and self.crosshair is not None:
            # records the marker row AND freezes the crosshair as the
            # delta-readout anchor (`databrowser.py:909-939`)
            b.store_marker(label="start")
            self.status = f"marker at {self.crosshair[1]:.4f}s"
        elif key == "t":
            self.starttime_mode = (self.starttime_mode + 1) % 3
        elif key == "c":
            b.toggle_colorbars()
        elif key == "z":
            b.toggle_powers()
        elif key == "s":
            path = Path(str(b.data.file_path)).with_suffix(".view.png")
            save_view_screenshot(self.fig, b, path)
            print(f"saved screenshot to {path}")
        elif key == "q":
            self.close()
            return
        else:
            return
        if serial == self._redraw_serial:
            # verbs that emit browser signals already redrew through
            # _linked_redraw; repeat only for local-only keys (modes,
            # 't', crosshair, ...) — the full pass repeats device pulls
            self.redraw()

    def _tick(self):
        """50 ms timer: advance auto-scroll and the playback marker,
        and swap in a pending NFFT bucket once its programs are warm."""
        b = self.browser
        if self._closed:
            return
        # set_resolution redraws through sigResolutionChanged
        b.poll_pending_resolution()
        if b.scroll_active:
            b.scroll_further()  # set_times redraws through the signal
        self._audio_t = b.mark_audio()
        if self._audio_t is not None and not b.scroll_active:
            # only the marker moved: reposition it without a full pass
            for key, art in self._artists.items():
                if isinstance(key, tuple) and key[0] == "trace":
                    art["audio"].set_visible(True)
                    art["audio"].set_xdata([self._audio_t] * 2)
            self.fig.canvas.draw_idle()
        if not b.scroll_active and self._audio_t is None:
            for key, art in self._artists.items():
                if isinstance(key, tuple) and "audio" in art:
                    art["audio"].set_visible(False)
            self.fig.canvas.draw_idle()
            if not b.has_pending_resolution:
                self.timer.stop()

    def _update_timer(self):
        """Run the 50 ms tick while auto-scroll or playback is active,
        or a snapped resolution step waits for its warmed bucket."""
        if (self.browser.scroll_active or self.browser.audio_time >= 0
                or self.browser.has_pending_resolution):
            self.timer.start()
        else:
            self.timer.stop()

    def _stop_audio(self):
        try:
            import sounddevice

            sounddevice.stop()
        except Exception:
            pass

    def _play(self, data, rate):
        try:
            import sounddevice

            sounddevice.play(np.asarray(data), int(rate), blocking=False)
        except Exception as e:  # no module, no device, PortAudio errors
            print(f"cannot play audio: {e}")
            # disarm playback state: a stale audio_time >= 0 would eat
            # the next Space press and animate a silent cursor
            self.browser.audio_time = -1.0
        self._update_timer()

    def savefig(self, path, **kwargs):
        save_view_screenshot(self.fig, self.browser, path, **kwargs)
        return path


def show(shell, block=True):
    """Open one window per loaded recording and run the event loop."""
    import matplotlib.pyplot as plt

    windows = [MplBrowserWindow(b) for b in shell.browsers]
    if block:
        plt.show()
    return windows
