"""Interactive song-detection viewer (matplotlib).

Rebuild of the reference's ``SignalPlot`` (`songdetector.py:250-681`): one
amplitude panel per channel showing the raw trace (blue), the band-passed
trace (green), the fast envelope (red), the slow envelope (cyan), the
per-channel detection threshold (black), and the detected song on/offsets
(dots at the threshold), with the reference's keyboard surface — time
scroll/zoom, amplitude zoom, per-layer visibility toggles, interactive
filter/envelope cutoff changes that re-run the device pipeline, audio
playback of the visible window, and waveform PNG export.

Works under any matplotlib backend including headless Agg (call
:meth:`SongPlot.savefig`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..analysis import events

__all__ = ["SongPlot", "show"]

HELP = """(ctrl+) pageup/down, up/down, home/end: scroll
+/=/X, -/x: zoom time in/out     y/Y, v/V: zoom amplitudes
ctrl+t/ctrl+f/ctrl+e: toggle raw/filtered/envelope layers
h/H, l/L: high/lowpass cutoff    e/E: envelope cutoff
p/P: play filtered/raw window    w: save waveform PNG
?: toggle this help              q: quit"""


def _strip_default_keymaps(plt):
    """Remove matplotlib default key bindings that collide with the
    viewer's keys (the reference clears these rcParams too,
    `songdetector.py:304-312`); covers the toolmanager routing that has
    no key_press_handler_id to disconnect."""
    for name in ("keymap.fullscreen", "keymap.save", "keymap.yscale",
                 "keymap.xscale", "keymap.grid", "keymap.grid_minor",
                 "keymap.home", "keymap.back", "keymap.forward",
                 "keymap.pan", "keymap.zoom"):
        if name in plt.rcParams:
            plt.rcParams[name] = []


class SongPlot:
    """Per-channel trace/envelope/threshold viewer over a detection
    result (the dict :func:`audian_tpu.analysis.events.detect` returns)."""

    def __init__(self, data, rate, result, cfg=None, filename="",
                 figsize=(15, 9), max_pixel=50000):
        import matplotlib.pyplot as plt

        self.plt = plt
        self.data = np.asarray(data)
        if self.data.dtype == np.int16:
            # raw PCM-16 from the CLI's raw16 load path: the viewer's
            # amplitude axes and playback expect float samples
            self.data = self.data.astype(np.float32)
            self.data /= 32768.0  # in place: no second full copy
        self.rate = float(rate)
        self.result = result
        self.filename = str(filename)
        self.channels = self.data.shape[1]
        self.max_pixel = int(cfg.value("maxpixel")) if cfg else max_pixel
        self.highpassfreq = cfg.value("highpassfreq") if cfg else 1000.0
        self.lowpassfreq = cfg.value("lowpassfreq") if cfg else 10000.0
        self.envelopecutofffreq = (cfg.value("envelopecutofffreq")
                                   if cfg else 500.0)
        self.min_duration = cfg.value("minduration") if cfg else 0.5
        # the remaining detect() knobs: a recompute must reuse the
        # config the original result was produced with, or the viewer
        # silently diverges from the CSV the same run just wrote
        self.envelopefilter = cfg.value("envelopefilter") if cfg else "apply"
        self.envelopepeakthresh = (cfg.value("envelopepeakthresh")
                                   if cfg else 10.0)
        self.minthreshfac = cfg.value("minthreshfac") if cfg else 1.0
        self.toffset = 0.0
        duration = self.data.shape[0] / self.rate
        self.twindow = min(60.0, 2 ** np.ceil(np.log2(max(duration, 1e-3))))
        self.show_traces = True
        self.show_filtered = True
        self.show_envelope = True
        self.show_slowenvelope = True
        self.show_thresholds = True
        self.show_help = False
        self.ymin = np.full(self.channels, -1.0)
        self.ymax = np.full(self.channels, +1.0)
        for c in range(self.channels):
            col = self.data[:, c]
            m = max(float(col.max(initial=0.0)),
                    -float(col.min(initial=0.0)))  # no abs() temporary
            if m > 1.0:
                self.ymin[c], self.ymax[c] = -10.0, 10.0
        self.fig, axs = plt.subplots(self.channels, 1, sharex=True,
                                     figsize=figsize, squeeze=False)
        self.axs = [a[0] for a in axs]
        try:
            self.fig.canvas.manager.set_window_title(
                "SongDetector: " + self.filename)
        except AttributeError:
            pass
        # the default key handler would fire on top of ours; ALSO
        # strip the conflicting rcParams keymaps like the reference
        # (`songdetector.py:304-312`) — under toolbar='toolmanager'
        # there is no key_press_handler_id to disconnect
        _strip_default_keymaps(plt)
        mgr = getattr(self.fig.canvas, "manager", None)
        kid = getattr(mgr, "key_press_handler_id", None)
        if kid is not None:
            self.fig.canvas.mpl_disconnect(kid)
        self.fig.canvas.mpl_connect("key_press_event", self.keypress)
        self._labels = None
        self._help_text = None
        if self.result.get("filtered") is None:
            # batch results skip pulling the filtered stream; fill ONLY
            # that (with the viewer's current cutoffs) — recomputing the
            # envelope/onsets here could silently overwrite detection
            # results produced with different parameters
            fdata, _env, _rate = events.band_env(
                self.data, self.rate, self.highpassfreq,
                self.lowpassfreq, self.envelopecutofffreq,
                return_filtered=True)
            self.result["filtered"] = fdata
        self.update_plots(draw=False)

    # -- drawing ------------------------------------------------------------------

    def _decimate(self, arr, t0, t1, rate):
        i0 = max(int(round(t0 * rate)), 0)
        i1 = min(int(round(t1 * rate)), len(arr))
        step = 1
        if self.max_pixel > 0:
            step = max((i1 - i0) // self.max_pixel, 1)
        idx = np.arange(i0, i1, step)
        return idx / rate, arr[i0:i1:step]

    def update_plots(self, draw=True):
        r = self.result
        t0, t1 = self.toffset, self.toffset + self.twindow
        envrate = r["envrate"]
        for c, ax in enumerate(self.axs):
            ax.clear()
            if self.show_traces:
                t, v = self._decimate(self.data[:, c], t0, t1, self.rate)
                ax.plot(t, v, "b", lw=0.5, zorder=0)
            if self.show_filtered:
                t, v = self._decimate(r["filtered"][:, c], t0, t1, self.rate)
                ax.plot(t, v, "g", lw=0.5, zorder=1)
            if self.show_envelope:
                t, v = self._decimate(r["envelope"][:, c], t0, t1, envrate)
                ax.plot(t, v, "r", lw=2, zorder=2)
            if self.show_slowenvelope:
                t, v = self._decimate(r["slow_envelope"][:, c], t0, t1,
                                      envrate)
                ax.plot(t, v, "c", lw=2, zorder=3)
            if self.show_thresholds:
                ax.axhline(r["thresholds"][c], color="k", lw=1, zorder=4)
                ons = np.asarray(r["onsets"][c])
                offs = np.asarray(r["offsets"][c])
                thr = r["thresholds"][c]
                ax.plot(ons, np.full(len(ons), thr), ".b", ms=10, zorder=5)
                ax.plot(offs, np.full(len(offs), thr), ".b", ms=10, zorder=6)
                for a, b in zip(ons, offs):
                    if b >= t0 and a <= t1:
                        ax.axvspan(a, b, color="#ffdd55", alpha=0.2,
                                   zorder=-1)
            ax.set_xlim(t0, t1)
            ax.set_ylim(self.ymin[c], self.ymax[c])
            ax.set_ylabel("Amplitude")
        self.axs[-1].set_xlabel("Time [s]")
        self._labels = self.axs[0].text(
            0.02, 0.92,
            f"highpass={0.001 * self.highpassfreq:.1f}kHz   "
            f"lowpass={0.001 * self.lowpassfreq:.1f}kHz   "
            f"envelope={self.envelopecutofffreq:.0f}Hz",
            transform=self.axs[0].transAxes, fontsize=9)
        if self.show_help:
            self._help_text = self.axs[0].text(
                0.98, 0.05, HELP, ha="right", va="bottom", fontsize=8,
                transform=self.axs[0].transAxes,
                bbox=dict(fc="white", alpha=0.8))
        if draw:
            self.fig.canvas.draw_idle()

    # -- pipeline re-runs ------------------------------------------------------------

    def _refilter(self):
        self._recompute(return_filtered=True)

    def _reenvelope(self):
        # envelope-only change: the filtered stream is unchanged — skip
        # its (hundreds of MB) device->host pull
        self._recompute(
            return_filtered=self.result.get("filtered") is None)

    def _recompute(self, return_filtered):
        # one chunked fused device pass for filter + envelope (fixed
        # compiled shape; the previous per-stage path ran eager
        # full-length programs with a host round trip in between)
        r = self.result
        fdata, env, envrate = events.band_env(
            self.data, self.rate, self.highpassfreq, self.lowpassfreq,
            self.envelopecutofffreq, return_filtered=return_filtered)
        if return_filtered:
            r["filtered"] = fdata
        r["envelope"] = np.ascontiguousarray(env)
        r["envrate"] = envrate
        slow = events.lowpass_filter(r["envelope"], envrate,
                                     1.0 / self.min_duration)
        r["slow_envelope"] = np.asarray(slow)
        ons, offs = events.detect_songs(r["slow_envelope"], envrate,
                                        r["thresholds"], self.min_duration)
        # the full refinement chain the batch pipeline runs — the
        # reference's keypress handler likewise re-refines
        # (`songdetector.py:617-619`), so refinement-rejected songs do
        # not reappear after a scrub
        freqs = events.env_freqs(ons, offs, r["envelope"], envrate,
                                 thresh=self.envelopepeakthresh)
        ons, offs, freqs = events.clean_env_freqs(ons, offs, freqs)
        if self.envelopefilter in ("apply", "average"):
            events.filter_envelopes(ons, offs, freqs, r["envelope"],
                                    envrate, self.min_duration,
                                    self.envelopefilter)
        ons, offs = events.analyse_songs(ons, offs, r["envelope"], envrate,
                                         freqs, r["thresholds"],
                                         self.min_duration,
                                         self.minthreshfac)
        r["onsets"] = [o / envrate for o in ons]
        r["offsets"] = [o / envrate for o in offs]
        r["onset_indices"] = ons
        r["offset_indices"] = offs

    # -- interaction ------------------------------------------------------------------

    def keypress(self, event):
        key = event.key
        duration = self.data.shape[0] / self.rate
        if key in ("+", "=", "X"):
            if self.twindow * self.rate > 20:
                self.twindow *= 0.5
        elif key in ("-", "x"):
            if self.twindow < duration:
                self.twindow *= 2.0
        elif key == "pagedown":
            self.toffset = min(self.toffset + 0.5 * self.twindow,
                               max(duration - self.twindow, 0.0))
        elif key == "pageup":
            self.toffset = max(self.toffset - 0.5 * self.twindow, 0.0)
        elif key == "ctrl+pagedown":
            self.toffset = min(self.toffset + 5.0 * self.twindow,
                               max(duration - self.twindow, 0.0))
        elif key == "ctrl+pageup":
            self.toffset = max(self.toffset - 5.0 * self.twindow, 0.0)
        elif key == "down":
            self.toffset = min(self.toffset + 0.05 * self.twindow,
                               max(duration - self.twindow, 0.0))
        elif key == "up":
            self.toffset = max(self.toffset - 0.05 * self.twindow, 0.0)
        elif key == "home":
            self.toffset = 0.0
        elif key == "end":
            # strict-epsilon floor: an exact multiple would otherwise
            # land the window entirely past the data (blank panels)
            self.toffset = max(
                np.floor((duration - 1e-9) / self.twindow) * self.twindow,
                0.0)
        elif key == "y":  # zoom amplitude out
            h = self.ymax - self.ymin
            v = 0.5 * (self.ymax + self.ymin)
            self.ymin, self.ymax = v - h, v + h
        elif key == "Y":  # zoom amplitude in
            h = 0.25 * (self.ymax - self.ymin)
            v = 0.5 * (self.ymax + self.ymin)
            self.ymin, self.ymax = v - h, v + h
        elif key == "v":  # fit to filtered data
            for c in range(self.channels):
                m = float(np.abs(self.result["filtered"][:, c]).max())
                self.ymin[c], self.ymax[c] = -m, m
        elif key == "V":
            self.ymin[:], self.ymax[:] = -1.0, 1.0
        elif key == "ctrl+t":
            self.show_traces = not self.show_traces
        elif key == "ctrl+f":
            self.show_filtered = not self.show_filtered
        elif key == "ctrl+e":
            self.show_envelope = not self.show_envelope
            self.show_slowenvelope = self.show_envelope
        elif key in ("h", "H"):
            self.highpassfreq *= (1 / 1.5) if key == "h" else 1.5
            self._refilter()
        elif key in ("l", "L"):
            self.lowpassfreq *= (1 / 1.5) if key == "l" else 1.5
            self._refilter()
        elif key in ("e", "E"):
            self.envelopecutofffreq *= (1 / 1.5) if key == "e" else 1.5
            self._reenvelope()
        elif key == "w":
            self.save_waveform()
            return
        elif key == "p":
            self._play(self.result["filtered"])
            return
        elif key == "P":
            self._play(self.data)
            return
        elif key == "?":
            self.show_help = not self.show_help
        elif key == "q":
            self.plt.close(self.fig)
            return
        else:
            return
        self.update_plots()

    def save_waveform(self, path=None):
        """One-panel waveform PNG of the visible window
        (`songdetector.py:645-672`)."""
        name = Path(self.filename).stem or "song"
        if path is None:
            path = f"{name}-{self.toffset:.4g}s-waveform.png"
        fig, ax = self.plt.subplots(figsize=(10, 4))
        t0 = int(round(self.toffset * self.rate))
        t1 = min(int(round((self.toffset + self.twindow) * self.rate)),
                 len(self.data))
        ms = self.twindow < 1.0
        t = np.arange(t0, t1) / self.rate * (1000.0 if ms else 1.0)
        ax.plot(t, self.data[t0:t1], "b", lw=0.5)
        ax.set_xlabel("Time [ms]" if ms else "Time [s]")
        ax.set_ylabel("Amplitude")
        ax.set_title(self.filename)
        fig.tight_layout()
        fig.savefig(path)
        self.plt.close(fig)
        print(f"saved waveform figure to {path}")
        return Path(path)

    def _play(self, data):
        t0 = int(round(self.toffset * self.rate))
        t1 = int(round((self.toffset + self.twindow) * self.rate))
        play = np.mean(data[t0:t1, :], axis=1)
        play -= play.mean()
        # audioio sine-squared fade, host-side (playback windows come in
        # arbitrary lengths; an eager jnp fade would compile per shape).  nf clamps so short windows still
        # fade — a linear ramp skipped sub-0.2 s windows entirely and
        # clicked
        nf = min(int(round(0.1 * self.rate)), len(play) // 2)
        if nf > 0:
            ramp = np.sin(0.5 * np.pi * np.arange(nf) / nf) ** 2
            play[:nf] *= ramp
            play[-nf:] *= ramp[::-1]
        try:
            import sounddevice

            sounddevice.play(play, int(self.rate), blocking=False)
        except Exception as e:  # no module, no device, PortAudio errors
            print(f"cannot play audio: {e}")

    def savefig(self, path, **kwargs):
        self.fig.savefig(path, **kwargs)
        return Path(path)


def show(data, rate, result, cfg=None, filename="", block=True):
    """Open the viewer and run the event loop."""
    import matplotlib.pyplot as plt

    win = SongPlot(data, rate, result, cfg=cfg, filename=filename)
    if block:
        plt.show()
    return win
