"""Marker labels and marker data store (Qt-free).

Rebuild of the data core of `src/audian/markerdata.py:109-541`: marker
label definitions (name, key shortcut, color), the per-event marker table
(channel/time/amplitude/frequency/power + deltas + label/text), conversion
to/from the file-metadata ``locs``/``labels`` arrays, and CSV/XLSX export.
The Qt table-model/editor widgets of the reference are thin adapters in
the GUI layer; everything testable lives here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["MarkerLabel", "MarkerData"]


class MarkerLabel:
    """(`markerdata.py:109-121`)"""

    def __init__(self, label, key_shortcut, color, action=None):
        self.label = label
        self.key_shortcut = key_shortcut
        self.color = color
        self.action = action

    def copy(self):
        return MarkerLabel(self.label, self.key_shortcut, self.color,
                           self.action)

    def __repr__(self):
        return f"MarkerLabel({self.label!r}, {self.key_shortcut!r}, {self.color!r})"


def find_label(labels, key_shortcut):
    """First label bound to ``key_shortcut`` (case-insensitive, like the
    reference's QKeySequence comparison in ``find_action``,
    `markerdata.py:211-218`); None when unbound.  On duplicate keys the
    first match wins."""
    want = (key_shortcut or "").lower()
    for l in labels:
        if (l.key_shortcut or "").lower() == want:
            return l
    return None


def key_conflicts(labels):
    """NON-EMPTY key shortcuts (compared case-insensitively) used by more
    than one label.  Stricter than the reference, which only warns about
    label keys shadowing application actions (`markerdata.py:191-209`) —
    duplicate label keys would make marker keystrokes ambiguous here, so
    the editor dialog rejects them."""
    seen = {}
    for l in labels:
        key = (l.key_shortcut or "").lower()
        if key:
            seen.setdefault(key, []).append(l.label)
    return {k: v for k, v in seen.items() if len(v) > 1}


class MarkerData:
    """Event-marker table (`markerdata.py:327-423`)."""

    keys = ["channels", "times", "amplitudes", "frequencies", "powers",
            "delta_times", "delta_amplitudes", "delta_frequencies",
            "delta_powers", "labels", "texts"]
    headers = ["channel", "time/s", "amplitude", "frequency/Hz",
               "power/dB", "time-diff/s", "ampl-diff", "freq-diff/Hz",
               "power-diff/dB", "label", "text"]

    def __init__(self, marker_labels=None):
        self.file_path = None
        # keep the CALLER's list object (even when empty): the browser
        # and the label editor mutate it in place and rely on shared
        # identity
        self.marker_labels = (marker_labels if marker_labels is not None
                              else [])
        self.clear()

    def clear(self):
        for key in self.keys:
            setattr(self, key, [])

    def __len__(self):
        return len(self.times)

    def add_data(self, channel, time, amplitude=None, frequency=None,
                 power=None, delta_time=None, delta_amplitude=None,
                 delta_frequency=None, delta_power=None, label="", text=""):
        def _num(v):
            return v if v is not None else np.nan

        self.channels.append(channel)
        self.times.append(_num(time))
        self.amplitudes.append(_num(amplitude))
        self.frequencies.append(_num(frequency))
        self.powers.append(_num(power))
        self.delta_times.append(_num(delta_time))
        self.delta_amplitudes.append(_num(delta_amplitude))
        self.delta_frequencies.append(_num(delta_frequency))
        self.delta_powers.append(_num(delta_power))
        self.labels.append(label)
        self.texts.append(text)

    def set_label(self, index, label):
        self.labels[index] = label

    def set_text(self, index, text):
        self.texts[index] = text

    def remove(self, index):
        for key in self.keys:
            del getattr(self, key)[index]

    def data_frame(self):
        import pandas as pd

        return pd.DataFrame({h: getattr(self, k)
                             for k, h in zip(self.keys, self.headers)})

    # -- file-metadata marker conversion (`markerdata.py:399-423`) -------------------

    def set_markers(self, locs, labels, rate):
        """Load markers from the audio file's cue metadata: marker time is
        the END of the span, delta_time its length."""
        for i in range(len(locs)):
            l = t = ""
            if i < len(labels):
                l, t = labels[i, 0], labels[i, 1]
            tstart = float(locs[i, 0]) / rate
            tspan = float(locs[i, 1]) / rate
            self.add_data(0, tstart + tspan, delta_time=tspan, label=l,
                          text=t)

    def get_markers(self, rate):
        n = len(self.times)
        locs = np.zeros((n, 2), dtype=int)
        labels = np.zeros((n, 2), dtype=object)
        for k in range(n):
            span = self.delta_times[k]
            ispan = int(np.round(span * rate)) if np.isfinite(span) else 0
            t1 = self.times[k]
            # rows without a time (frequency-only markers) export at 0
            # rather than crashing int(nan)
            i1 = int(np.round(t1 * rate)) if np.isfinite(t1) else ispan
            locs[k, 0] = i1 - ispan
            locs[k, 1] = ispan
            labels[k, 0] = self.labels[k]
            labels[k, 1] = self.texts[k]
        return locs, labels

    # -- export (`markerdata.py:508-529`) ---------------------------------------------

    def save(self, file_path):
        """CSV or (with openpyxl) XLSX export.  Without openpyxl an
        .xlsx request degrades to CSV with a printed notice; callers
        should surface the RETURNED path (it may differ)."""
        df = self.data_frame()
        path = Path(file_path)
        if path.suffix.lower() == ".xlsx":
            try:
                df.to_excel(path, index=False)
                return path
            except (ImportError, ModuleNotFoundError):
                path = path.with_suffix(".csv")
                print(f"openpyxl is not installed: saving {path} instead"
                      f" (pip install audian-tpu[export])")
        df.to_csv(path, index=False)
        return path
