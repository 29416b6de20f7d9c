"""Trace graph nodes: pure compute + static geometry.

The reference's node protocol is the mutable ``BufferedData`` subclass
hierarchy with a ``process(source, dest, nbefore)`` hook writing into a
shared buffer (`src/audian/buffereddata.py:10-153`).  The device-first design
splits each node into:

- static *geometry*: which source frame range a given output frame range
  needs (halo / warm-up / STFT window math), resolved on the host;
- dynamic *params*: a pytree of traced arrays (filter coefficients, FIR
  kernels, STFT window) that can change value without recompiling;
- a pure ``compute(source_slice, lead, n_out, params)`` function traced by
  XLA.

Halos are declared in seconds exactly like the reference
(``source_tbefore/source_tafter``: filter 10 s warm-up
`src/audian/bufferedfilter.py:13`, envelope 1 s
`src/audian/bufferedenvelope.py:17`, spectrogram tail
`src/audian/bufferedspectrogram.py:17`).
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from ..ops import (
    FilterDesign,
    design_filter,
    design_envelope_filter,
    sosfilt_fir,
    sosfiltfilt_fir,
    spectrogram,
    spectrogram_frequencies,
    hann_window,
)
from .spec import TraceSpec


class Node:
    """Base class for derived-trace nodes.

    Subclasses set ``halo_before``/``halo_after`` (seconds of *source*
    context needed beyond the frames that map to the requested output) and
    implement :meth:`open`, :meth:`params` and :meth:`compute`.
    """

    #: seconds of source context required before/after the output window
    halo_before = 0.0
    halo_after = 0.0
    #: source frames advanced per output frame (integer; >1 decimates)
    step = 1
    #: additional source frames one output frame looks at beyond ``step``
    window = 1

    # display defaults, mirroring the reference's constructor args
    # (`src/audian/buffereddata.py:12-16`)
    panel = "trace"
    panel_type = "trace"
    color = "#00ee00"
    lw_thin = 1.1
    lw_thick = 2

    def __init__(self, name, source="data", panel=None, panel_type=None,
                 color=None, lw_thin=None, lw_thick=None):
        self.name = name
        self.source_name = source
        self.spec = None
        self.source_spec = None
        for attr, val in [("panel", panel), ("panel_type", panel_type),
                          ("color", color), ("lw_thin", lw_thin),
                          ("lw_thick", lw_thick)]:
            if val is not None:
                setattr(self, attr, val)

    # -- static geometry ----------------------------------------------------

    def open(self, source_spec: TraceSpec) -> TraceSpec:
        """Derive this node's output spec from its source's; design any
        filters.  Must set ``self.spec`` and return it."""
        self.source_spec = source_spec
        self.spec = source_spec
        return self.spec

    def halo_frames(self):
        """Source-frame halos ``(before, after)``: extra context beyond the
        frames the output window maps onto (window overhang is accounted
        for separately in the range math)."""
        sb = int(math.ceil(self.halo_before * self.source_spec.rate))
        sa = int(math.ceil(self.halo_after * self.source_spec.rate))
        return sb, sa

    def halo_seconds(self):
        """(before, after) in seconds of source time, including the STFT
        window overhang — the quantity the graph folds backward to size
        the raw fetch (`src/audian/data.py:154-166` analog).

        The overhang is ``window - 1`` (not ``window - step``): the last
        frame whose grid position falls inside a chunk can start up to
        ``step - 1`` samples before the chunk edge, so folding only
        ``window - step`` drops exactly one boundary frame whenever chunk
        edges are not step-aligned AND the upstream halos are smaller
        than a window (found by tests/test_graph_fuzz.py).  The aligned
        interactive path never sees the difference; arbitrary
        :class:`GraphExecutor` chunkings stay gap-free for free."""
        overhang = max(self.window - 1, 0) / self.source_spec.rate
        return self.halo_before, self.halo_after + overhang

    def source_range(self, o0, o1):
        """Source frame range (with halos, clipped to the recording) that
        producing output frames ``[o0, o1)`` requires.

        Returns ``(s0, s1, lead)`` where ``lead`` is the number of warm-up
        source frames preceding the first output-aligned source frame (the
        reference's ``nbefore``, `src/audian/buffereddata.py:94-107`).
        """
        sb, sa = self.halo_frames()
        anchor = o0 * self.step
        s0 = max(anchor - sb, 0)
        s1 = min((o1 - 1) * self.step + self.window + sa,
                 self.source_spec.frames)
        return s0, s1, anchor - s0

    def out_range_for_source(self, s0, s1):
        """Largest output frame range computable from source frames
        ``[s0, s1)`` under this node's halo requirements (used when walking
        the graph forward from a raw window).

        At the recording edges halos/windows are relaxed the way the
        reference relaxes them: no warm-up exists before frame 0, and tail
        output frames may see partial windows
        (`src/audian/buffereddata.py:75-88`).
        """
        sb, sa = self.halo_frames()
        lo = s0 + (sb if s0 > 0 else 0)
        hi = s1 - (sa if s1 < self.source_spec.frames else 0)
        o0 = -(-lo // self.step)
        if s1 >= self.source_spec.frames:
            o1 = self.spec.frames
        else:
            o1 = (hi - self.window) // self.step + 1
        return o0, max(o1, o0)

    # -- dynamic part --------------------------------------------------------

    def params(self):
        """Pytree of traced parameters consumed by :meth:`compute`."""
        return None

    def static_key(self):
        """Hashable summary of every attribute :meth:`compute` bakes into
        the traced program (beyond the params pytree).  Executor cache key
        component — must change whenever compute's *structure* changes."""
        return (type(self).__name__,)

    def compute(self, source, lead, n_out, params):
        """Pure function: map ``source`` (shape ``(ns, channels, ...)``,
        including ``lead`` warm-up frames) to ``n_out`` output frames."""
        raise NotImplementedError

    def compute_host(self, source, lead, n_out):
        """Host (numpy/scipy) twin of :meth:`compute` for device-loss
        mode (`GraphExecutor.run_host`).  Must never touch jax.  The
        built-in nodes override with their scipy oracles; unknown node
        types degrade to zeros so a lost device still cannot hang the
        session."""
        source = np.asarray(source)
        return np.zeros((n_out,) + source.shape[1:], np.float32)

    def update(self, **kwargs):
        """Host-side parameter update (filter redesign etc.).  Returns True
        when downstream recomputation is needed."""
        return False


class FilterNode(Node):
    """On-the-fly Butterworth high/low/band-pass.

    Reference parity: `src/audian/bufferedfilter.py:9-53` — same default
    cutoffs, same pass-through rule, same 10 s warm-up halo; but the data
    path is the matmul FIR fast path of :mod:`audian_tpu.ops.sos` and a
    redesign never recompiles (the design is a traced pytree).
    """

    color = "#00ee00"

    def __init__(self, name="filtered", source="data", **kwargs):
        super().__init__(name, source, **kwargs)
        self.highpass_cutoff = 0.0
        self.lowpass_cutoff = None
        self.filter_order = 2
        self.design = None
        self._sos = None
        self._kernel_len = 0  # sticky FIR length budget (see _redesign)

    @property
    def halo_before(self):
        """Warm-up halo derived from the actual impulse-response decay
        length of the current design — exact where the reference uses a
        blunt 10 s constant (`src/audian/bufferedfilter.py:13`), so chunk
        fetches stay minimal."""
        if self.design is None or self.source_spec is None:
            return 0.0
        return self.design.fir.length / self.source_spec.rate

    def open(self, source_spec):
        # defaults only on FIRST open (or a rate change): add_trace
        # re-opens the whole graph, and the reference never resets a
        # user's cutoffs when another trace is added
        # (`src/audian/data.py:34-46` only appends)
        first = (self.source_spec is None
                 or self.source_spec.rate != source_spec.rate)
        self.source_spec = source_spec
        self.spec = source_spec
        if first:
            self.highpass_cutoff = 0.0
            self.lowpass_cutoff = source_spec.rate / 2
            self.design = None
        self._redesign()
        return self.spec

    def _redesign(self):
        sos = design_filter(self.source_spec.rate, self.highpass_cutoff,
                            self.lowpass_cutoff, self.filter_order)
        self._sos = sos  # host scipy twin for device-loss mode
        old = self.design
        if sos is None:
            self.design = None
        else:
            # Sticky kernel-length budget: start generously (4x the natural
            # decay length) and only ever grow, so scrubbing a cutoff keeps
            # the FIR shapes — and therefore the compiled program — stable.
            d = FilterDesign.from_sos(sos, pad_to=self._kernel_len or None)
            if self._kernel_len == 0:
                d = FilterDesign.from_sos(sos, pad_to=4 * d.fir.length)
            self._kernel_len = max(self._kernel_len, d.fir.length)
            self.design = d
        return (old is None) != (self.design is None)

    def update(self, highpass_cutoff=None, lowpass_cutoff=None, order=None):
        if highpass_cutoff is not None:
            self.highpass_cutoff = highpass_cutoff
        if lowpass_cutoff is not None:
            self.lowpass_cutoff = lowpass_cutoff
        if order is not None:
            self.filter_order = order
        self._redesign()
        return True

    def params(self):
        return self.design

    def static_key(self):
        return ("filter", self.design is None)

    def compute(self, source, lead, n_out, params):
        if params is None:  # pass-through (bufferedfilter.py:32-33)
            return source[lead : lead + n_out]
        y = sosfilt_fir(params.fir, source, axis=0, return_zf=False)
        return y[lead : lead + n_out]

    def compute_host(self, source, lead, n_out):
        """scipy ``sosfilt`` twin of :meth:`compute` (device-loss mode);
        the IIR cascade the FIR fast path approximates at <=1e-5."""
        source = np.asarray(source)
        if self.design is None:
            return np.asarray(source[lead : lead + n_out], np.float32)
        from scipy.signal import sosfilt

        y = sosfilt(self._sos, source.astype(np.float64), axis=0)
        return y[lead : lead + n_out].astype(np.float32)


class EnvelopeNode(Node):
    """Rectified zero-phase envelope.

    Reference parity: `src/audian/bufferedenvelope.py:11-55` (pi/2
    rectification, sosfiltfilt smoothing, clamp at zero for pure lowpass).
    Unlike the reference we also declare a *trailing* halo — sosfiltfilt is
    anti-causal too, so chunked execution needs future context for exact
    chunk/whole equivalence.
    """

    color = "#ff8800"
    lw_thin = 2.5
    lw_thick = 4

    @property
    def halo_before(self):
        """Zero-phase smoothing is symmetric: both halos are the impulse
        decay length plus the scipy edge padding (the reference's fixed
        1 s, `src/audian/bufferedenvelope.py:17`, is neither exact nor
        two-sided)."""
        if self.design is None or self.source_spec is None:
            return 0.0
        return (self.design.fir.length + self.design.padlen) / self.source_spec.rate

    halo_after = halo_before

    def __init__(self, name="envelope", source="filtered",
                 envelope_cutoff=500.0, highpass_cutoff=0.0, filter_order=2,
                 **kwargs):
        super().__init__(name, source, **kwargs)
        self.envelope_cutoff = envelope_cutoff
        self.highpass_cutoff = highpass_cutoff
        self.filter_order = filter_order
        self.design = None
        self._sos = None
        self._kernel_len = 0

    def open(self, source_spec):
        self.source_spec = source_spec
        self.spec = source_spec
        self._redesign()
        return self.spec

    def _redesign(self):
        sos = design_envelope_filter(self.source_spec.rate,
                                     self.envelope_cutoff,
                                     self.highpass_cutoff,
                                     self.filter_order)
        self._sos = sos  # host scipy twin for device-loss mode
        if sos is None:
            self.design = None
            return
        # sticky kernel-length budget, same rationale as FilterNode
        d = FilterDesign.from_sos(sos, pad_to=self._kernel_len or None)
        if self._kernel_len == 0:
            d = FilterDesign.from_sos(sos, pad_to=4 * d.fir.length)
        self._kernel_len = max(self._kernel_len, d.fir.length)
        self.design = d

    def update(self, envelope_cutoff=None, highpass_cutoff=None, order=None):
        if envelope_cutoff is not None:
            self.envelope_cutoff = envelope_cutoff
        if highpass_cutoff is not None:
            self.highpass_cutoff = highpass_cutoff
        if order is not None:
            self.filter_order = order
        self._redesign()
        return True

    def params(self):
        return self.design

    def static_key(self):
        return ("envelope", self.design is None, self.highpass_cutoff == 0,
                None if self.design is None else self.design.padlen)

    def compute(self, source, lead, n_out, params):
        if params is None:  # infeasible design -> zeros (bufferedenvelope.py:36-37)
            return jnp.zeros((n_out,) + source.shape[1:], source.dtype)
        if source.shape[0] <= params.padlen:
            # same short-input guard as compute_host: a window shorter
            # than the filtfilt pad cannot be reflected — zeros, not a
            # trace-time ValueError (shapes are static, so plain `if`)
            return jnp.zeros((n_out,) + source.shape[1:], source.dtype)
        rect = (jnp.pi / 2) * jnp.abs(source)
        env = sosfiltfilt_fir(params.fir, rect, params.zi0, params.padlen,
                              axis=0)
        if self.highpass_cutoff == 0:
            env = jnp.maximum(env, 0.0)
        return env[lead : lead + n_out]

    def compute_host(self, source, lead, n_out):
        """scipy ``sosfiltfilt`` twin of :meth:`compute` (device-loss
        mode), same rectification / padlen / clamp rules."""
        source = np.asarray(source)
        if self.design is None:
            return np.zeros((n_out,) + source.shape[1:], np.float32)
        from scipy.signal import sosfiltfilt

        rect = (np.pi / 2) * np.abs(source.astype(np.float64))
        if rect.shape[0] <= self.design.padlen:
            return np.zeros((n_out,) + source.shape[1:], np.float32)
        env = sosfiltfilt(self._sos, rect, axis=0,
                          padlen=self.design.padlen)
        if self.highpass_cutoff == 0:
            env = np.maximum(env, 0.0)
        return env[lead : lead + n_out].astype(np.float32)


class SpectrogramNode(Node):
    """STFT power spectrogram trace.

    Reference parity: `src/audian/bufferedspectrogram.py:12-126` — output
    rate ``source_rate/hop``, frequency axis ``nfft//2+1``, NFFT/overlap
    re-spec through :meth:`update` with the same clamping rules.  NFFT and
    hop are static (they set shapes); interactive NFFT sweeps batch over
    pre-compiled buckets instead of recompiling blindly.
    """

    halo_after = 0.0  # true requirement is the window overhang, see `window`
    panel = "spectrogram"
    panel_type = "spectrogram"

    def __init__(self, name="spectrogram", source="filtered", nfft=256,
                 overlap_frac=0.5, **kwargs):
        super().__init__(name, source, **kwargs)
        self.nfft = int(nfft)
        self.overlap_frac = float(overlap_frac)
        self.hop = max(int(round((1 - self.overlap_frac) * self.nfft)), 1)

    # geometry ---------------------------------------------------------------

    @property
    def step(self):
        return self.hop

    @property
    def window(self):
        return self.nfft

    def _set_hop(self):
        """Clamp hop to [1, nfft] and keep overlap_frac consistent
        (`src/audian/bufferedspectrogram.py:69-81`)."""
        hop = int(round((1 - self.overlap_frac) * self.nfft))
        hop = min(max(hop, 1), self.nfft)
        changed = hop != self.hop
        self.hop = hop
        self.overlap_frac = 1 - hop / self.nfft
        return changed

    def open(self, source_spec):
        self.source_spec = source_spec
        self._set_hop()
        nbins = self.nfft // 2 + 1
        frames = -(-source_spec.frames // self.hop)
        self.spec = source_spec.decimate(
            self.hop, frames=frames, more_shape=(nbins,),
            unit=f"{source_spec.unit}^2/Hz", ampl_min=0.0,
            ampl_max=source_spec.rate / 2,
        )
        return self.spec

    @property
    def frequencies(self):
        return spectrogram_frequencies(self.source_spec.rate, self.nfft)

    @property
    def fresolution(self):
        return self.source_spec.rate / self.nfft

    @property
    def tresolution(self):
        return self.hop / self.source_spec.rate

    def update(self, nfft=None, overlap_frac=None):
        """Re-spec NFFT/overlap with the reference's clamping
        (`src/audian/bufferedspectrogram.py:83-106`).  Returns True when
        geometry changed (caller must re-open the chain downstream)."""
        changed = False
        if nfft is not None:
            nfft = max(int(nfft), 8)
            max_nfft = min(self.source_spec.frames // 2, 2 ** 30)
            nfft = min(nfft, max_nfft)
            if nfft != self.nfft:
                self.nfft = nfft
                changed = True
        if overlap_frac is not None:
            self.overlap_frac = min(max(float(overlap_frac), 0.0), 0.99999)
        if self._set_hop():
            changed = True
        if changed:
            self.open(self.source_spec)
        return changed

    # compute ----------------------------------------------------------------

    def params(self):
        return hann_window(self.nfft)

    def static_key(self):
        return ("spectrogram", self.nfft, self.hop)

    def compute(self, source, lead, n_out, params):
        # lead is already a multiple-of-hop alignment offset
        usable = source[lead:]
        nf = max((usable.shape[0] - self.nfft) // self.hop + 1, 0)
        nf = min(nf, n_out)
        nbins = self.nfft // 2 + 1
        if nf <= 0:
            return jnp.zeros((n_out,) + source.shape[1:] + (nbins,),
                             source.dtype)
        sxx = spectrogram(usable, self.source_spec.rate, self.nfft, self.hop,
                          window=params)[:nf]
        if nf < n_out:
            # tail frames whose STFT window overhangs the chunk: zero, the
            # reference does the same (`bufferedspectrogram.py:60-62`)
            pad = [(0, n_out - nf)] + [(0, 0)] * (sxx.ndim - 1)
            sxx = jnp.pad(sxx, pad)
        return sxx

    def compute_host(self, source, lead, n_out):
        """scipy ``spectrogram`` twin of :meth:`compute` (device-loss
        mode) — the documented oracle of :func:`audian_tpu.ops.stft.
        spectrogram` (density-scaled PSD, periodic Hann, no detrend)."""
        from scipy.signal import spectrogram as sp_spectrogram

        source = np.asarray(source)
        usable = source[lead:]
        nf = max((usable.shape[0] - self.nfft) // self.hop + 1, 0)
        nf = min(nf, n_out)
        nbins = self.nfft // 2 + 1
        out = np.zeros((n_out,) + source.shape[1:] + (nbins,), np.float32)
        if nf > 0:
            _f, _t, sxx = sp_spectrogram(
                usable.astype(np.float64), fs=self.source_spec.rate,
                window="hann", nperseg=self.nfft,
                noverlap=self.nfft - self.hop, detrend=False,
                scaling="density", mode="psd", axis=0)
            # scipy puts frequency on the input's time axis and time
            # last: (nbins, ..., nf) -> (nf, ..., nbins)
            sxx = np.moveaxis(np.moveaxis(sxx, 0, -1), -2, 0)
            out[:nf] = sxx[:nf].astype(np.float32)
        return out

    def estimate_noiselevels(self, power_db_tail, power_db_all):
        """Auto color levels from the noise floor, reference rules
        (`src/audian/bufferedspectrogram.py:109-126`): zmin = 95th
        percentile of the top-frequency-sixteenth dB values, zmax
        compressed to 95 % of the span, clamped to [20, 80] dB."""
        zmin = float(np.percentile(power_db_tail, 95))
        zmax = float(np.max(power_db_all))
        if not (np.isfinite(zmin) and np.isfinite(zmax)):
            return None, None
        zmax = zmin + 0.95 * (zmax - zmin)
        if zmax - zmin < 20:
            zmax = zmin + 20
        if zmax - zmin > 80:
            zmin = zmax - 80
        return zmin, zmax
