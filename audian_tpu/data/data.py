"""The ``Data`` registry: raw loader + derived-trace DAG + windowed updates.

Public API parity with the reference's ``Data`` class
(`src/audian/data.py:14-236`): dict-like access by trace name,
``get_region``, ``add_trace``/``remove_trace``, ``update_times``, halo-aware
buffer sizing — but the derived traces are computed on the device through
:class:`audian_tpu.graph.GraphExecutor` instead of per-node scipy calls on
the GUI thread.
"""

from __future__ import annotations

import functools
import math
from collections import deque

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..graph import (
    TraceGraph,
    TraceSpec,
    GraphExecutor,
    FilterNode,
    EnvelopeNode,
    SpectrogramNode,
    RAW,
)
from . import wavio
from .loader import AudioLoader
from ..ops import raw16
from ..utils import pow2_at_least as _pow2ceil
from ..utils.devicewatch import DeviceLost, watch as _devwatch


#: PCM-16 -> f32 on device (shared raw16 convention, `ops/raw16.py`)
_dequant16 = jax.jit(raw16.dequant16)


@functools.partial(jax.jit, static_argnames=("tail",))
def _slide_window(old, new, shift, tail):
    """Slide a device-resident window by ``shift`` frames and overwrite
    its leading/trailing ``len(new)`` frames with fresh data.  ``shift``
    is traced so every scroll step reuses one compiled program; ``new``
    is bucketed to a power-of-two length by the callers.  The region the
    roll wraps incorrectly is always inside the overwritten block
    (``len(new) >= |shift|``)."""
    rolled = jnp.roll(old, -shift, axis=0)
    zeros = (0,) * (old.ndim - 1)
    if tail:
        start = (old.shape[0] - new.shape[0],) + zeros
    else:
        start = (0,) + zeros
    return lax.dynamic_update_slice(rolled, new, start)


@functools.partial(jax.jit, static_argnames=("width",))
def _dev_slice(buf, start, width):
    return lax.dynamic_slice_in_dim(buf, start, width, axis=0)


@jax.jit
def _slide_patch(old, delta, shift, pos):
    """Slide a derived trace's device window by ``shift`` output frames
    and patch the recomputed ``delta`` frames in at ``pos`` (both
    traced)."""
    rolled = jnp.roll(old, -shift, axis=0)
    zeros = (jnp.int32(0),) * (old.ndim - 1)
    return lax.dynamic_update_slice(rolled, delta,
                                    (jnp.int32(pos),) + zeros)


class Trace:
    """Host-side windowed view of one trace (raw or derived).

    Exposes the reference's ``BufferedData`` consumer surface — ``rate,
    channels, frames, shape, offset, buffer, buffer_changed, name, panel,
    color...`` plus ``__getitem__`` that serves any range, computing out-of
    -window requests on demand (`src/audian/buffereddata.py` analog).
    Node attributes (``nfft``, ``frequencies``, cutoffs, ...) are reachable
    through attribute delegation.
    """

    def __init__(self, node, data):
        self._node = node
        self._data = data
        self.offset = 0
        self.buffer = np.zeros((0,), np.float32)
        self.buffer_changed = np.zeros(node.spec.channels, dtype=bool)
        self.plot_items = [None] * node.spec.channels
        self._visible = True

    # identity ---------------------------------------------------------------

    @property
    def name(self):
        return self._node.name

    @property
    def source_name(self):
        return self._node.source_name

    @property
    def spec(self):
        return self._node.spec

    @property
    def rate(self):
        return self._node.spec.rate

    @property
    def channels(self):
        return self._node.spec.channels

    @property
    def frames(self):
        return self._node.spec.frames

    @property
    def shape(self):
        return self._node.spec.shape

    @property
    def ndim(self):
        return self._node.spec.ndim

    @property
    def unit(self):
        return self._node.spec.unit

    @property
    def ampl_min(self):
        return self._node.spec.ampl_min

    @property
    def ampl_max(self):
        return self._node.spec.ampl_max

    #: attributes that live on the Trace itself; everything else delegates
    #: to the node so the reference idiom ``trace.highpass_cutoff = v;
    #: trace.update()`` (`src/audian/databrowser.py:1271-1283`) works
    _own_attrs = frozenset([
        "_node", "_data", "offset", "buffer", "buffer_changed",
        "plot_items", "_visible",
    ])

    def __getattr__(self, attr):
        # delegate node-specific API (nfft, frequencies, cutoffs, update...)
        return getattr(self._node, attr)

    def __setattr__(self, attr, value):
        if attr in Trace._own_attrs or attr.startswith("__"):
            object.__setattr__(self, attr, value)
        elif hasattr(type(self), attr):
            object.__setattr__(self, attr, value)
        else:
            setattr(self._node, attr, value)

    def __len__(self):
        return self.frames

    @property
    def content_epoch(self):
        """Generation counter of this trace's VALUES: scrolling the
        window leaves it unchanged (same global frames -> same values,
        the chunked==whole invariant), while any upstream parameter
        change bumps it.  Render caches key delta-reusable tile columns
        on it (:mod:`audian_tpu.view.render`).  While the trace is dirty
        (hidden during the change, window not yet refreshed) this is
        ``None`` — the buffer content does not correspond to the new
        epoch yet, so caches fall back to buffer-object identity."""
        name = self.name.lower()
        if name in self._data._dirty:
            return None
        return self._data._content_epoch.get(name, 0)

    def is_visible(self):
        vis = [pi.isVisible() for pi in self.plot_items if pi is not None]
        if vis:
            return any(vis)
        return self._visible

    def set_visible(self, show):
        self._visible = bool(show)
        for pi in self.plot_items:
            if pi is not None:
                pi.setVisible(show)
        # a trace updated while hidden was skipped by the lazy recompute
        # (its window is stale/dirty); showing it must refresh before the
        # GUI reads .buffer for tiles
        if show and self.name.lower() in self._data._dirty:
            self._data._recompute_buffer()

    # data access ---------------------------------------------------------------

    def _set_window(self, offset, array):
        self.offset = int(offset)
        self.buffer = array
        self.buffer_changed[:] = True

    def __getitem__(self, key):
        if isinstance(key, tuple):
            frame_key, rest = key[0], key[1:]
        else:
            frame_key, rest = key, ()
        if isinstance(frame_key, slice):
            start, stop, step = frame_key.indices(self.frames)
            if step < 0:  # numpy-style reversed slicing
                idx = np.arange(start, stop, step)
                if len(idx) == 0:
                    # empty result: never touch the compute path
                    data = np.zeros((0,) + tuple(np.shape(self.buffer)[1:]),
                                    np.float32)
                else:
                    lo = int(idx[-1])
                    data = self._range(lo, int(idx[0]) + 1)[idx - lo]
            else:
                data = self._range(start, stop)[::step]
            return data[(slice(None),) + rest] if rest else data
        idx = int(frame_key)
        if idx < 0:
            idx += self.frames
        row = self._range(idx, idx + 1)[0]
        return row[rest] if rest else row

    def _range(self, start, stop):
        start = max(0, min(start, self.frames))
        stop = max(start, min(stop, self.frames))
        if self.name.lower() in self._data._dirty:
            # the window holds pre-update content (parameter changed
            # while this trace was hidden): refresh the window once and
            # serve reads from it — per-access fresh computes would run
            # one device program per __getitem__ (an analyzer doing
            # per-index reads would pay a raw read + upload + chain run
            # + pull each time)
            if not self._data._refresh_trace(self.name):
                return self._data._compute_range(self.name, start, stop)
        if start >= self.offset and stop <= self.offset + len(self.buffer):
            a = start - self.offset
            w = stop - start
            if isinstance(self.buffer, jax.Array) and w:
                # bucketed jitted slice: an eager slice compiles a fresh
                # program per region length; pow2 widths reuse a handful
                cap = len(self.buffer)
                wb = min(_pow2ceil(w), cap)
                a2 = max(min(a, cap - wb), 0)
                try:
                    part = _devwatch.pull(
                        lambda: np.asarray(_dev_slice(self.buffer, a2,
                                                      wb)),
                        what=f"{self.name} slice")
                except DeviceLost:
                    # recompute this window host-side and serve from it
                    self._data._host_windows(targets=[self._node.name])
                    if isinstance(self.buffer, jax.Array):  # pragma: no cover
                        raise
                    a = start - self.offset  # window may have re-folded
                    if 0 <= a and a + w <= len(self.buffer):
                        return np.asarray(self.buffer[a : a + w])
                    return self._data._compute_range(self.name, start,
                                                     stop)
                return part[a - a2 : a - a2 + w]
            # transfer only the requested slice
            return np.asarray(self.buffer[a : a + w])
        return self._data._compute_range(self.name, start, stop)

    def update(self, **kwargs):
        """Host-side parameter update (filter cutoffs, NFFT, ...);
        triggers downstream recompute of the current window
        (`src/audian/bufferedfilter.py:39-53` analog)."""
        old_spec = self._node.spec
        changed = self._node.update(**kwargs)
        # geometry = the OUTPUT SPEC changed (NFFT/overlap respec) — only
        # then do downstream nodes need a re-open; node.update()'s return
        # means "recompute needed" and fires on every cutoff scrub
        self._data._after_update(
            self.name, geometry_changed=self._node.spec != old_spec)
        return changed


class RawTrace:
    """Adapter presenting the raw loader as trace number 0 named "data"
    (`src/audian/data.py:180-195`)."""

    name = RAW
    source_name = None
    panel = "trace"
    panel_type = "trace"
    color = "#0000ee"
    lw_thin = 1.1
    lw_thick = 2

    def __init__(self, loader):
        self._loader = loader
        self.plot_items = [None] * loader.channels
        self._visible = True

    def __getattr__(self, attr):
        return getattr(self._loader, attr)

    def __len__(self):
        return self._loader.frames

    def __getitem__(self, key):
        return self._loader[key]

    def is_visible(self):
        vis = [pi.isVisible() for pi in self.plot_items if pi is not None]
        if vis:
            return any(vis)
        return self._visible

    def set_visible(self, show):
        self._visible = bool(show)
        for pi in self.plot_items:
            if pi is not None:
                pi.setVisible(show)

    @property
    def spec(self):
        ld = self._loader
        return TraceSpec(rate=ld.rate, channels=ld.channels, frames=ld.frames,
                         ampl_min=ld.ampl_min, ampl_max=ld.ampl_max,
                         unit=ld.unit)


class Data:
    """Owns the raw loader plus the derived-trace DAG and drives windowed
    updates (reference parity: `src/audian/data.py:14-236`)."""

    def __init__(self, file_path, buffer_time=60.0, back_time=20.0,
                 follow_time=0.0, mesh=None, **load_kwargs):
        self.file_path = file_path
        self.load_kwargs = load_kwargs
        self.buffer_time = buffer_time
        self.back_time = back_time
        self.follow_time = follow_time
        #: optional jax Mesh with a "ch" axis: the device raw window (and
        #: through XLA's sharding propagation every derived window and
        #: render tile) is sharded channel-wise across the mesh — the
        #: interactive analog of the batch ShardedPipeline's channel
        #: axis (BASELINE config 3).  The chain is channel-independent,
        #: so no collectives are inserted; channel counts that do not
        #: divide the axis stay replicated.
        self.mesh = mesh
        self.data = None          # AudioLoader
        self.rate = None
        self.channels = 0
        self.frames = 0
        self.start_time = None
        self.meta_data = {}
        self.tbefore = 0.0
        self.tafter = 0.0
        self.graph = TraceGraph()
        self.executor = None
        self._traces = {}         # name -> Trace (derived only)
        self._content_epoch = {}  # trace name -> generation of its VALUES
        self._dirty = set()       # traces with stale content (hidden at
                                  # the time of a parameter update)
        self._raw = None
        # device mirror of the loader's host window (incremental updates)
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        # bumped whenever the mirror must be discarded (host-mode flip):
        # an ABANDONED watchdog thunk that unblocks when the device
        # answers again checks this before committing, so it cannot resurrect
        # a stale mirror or overwrite host-mode windows
        self._dev_gen = 0
        # recycled int16 upload-staging buffers by shape (see _put_raw)
        self._q_staging = {}
        #: True while trace windows hold HOST-computed content (device
        #: lost); flips back on the first successful device recompute
        self._host_mode = False

    # -- trace registry ----------------------------------------------------------

    def add_trace(self, node):
        self.graph.add(node)
        if self.data is not None:
            self._reopen_graph()
        return node

    def remove_trace(self, name):
        self.graph.remove(name)
        self._traces.pop(name.lower(), None)
        if self.data is not None:
            self._reopen_graph()

    def clear_traces(self):
        self.graph.clear()
        self._traces = {}

    def setup_traces(self):
        """Validate/order the DAG (raises MissingSourceError on dangling
        sources — the reference prints and drops,
        `src/audian/data.py:121-147`)."""
        return [n.name for n in self.graph.order]

    @property
    def traces(self):
        out = []
        if self._raw is not None:
            out.append(self._raw)
        out.extend(self._traces[n.name.lower()] for n in self.graph.order
                   if n.name.lower() in self._traces)
        return out

    def __len__(self):
        return len(self.traces)

    def __getitem__(self, key):
        key = key.lower()
        if key == RAW:
            return self._raw
        return self._traces.get(key)

    def __contains__(self, key):
        return self[key] is not None

    def keys(self):
        return [t.name for t in self.traces]

    def get_trace_names(self, node_class):
        return [self._traces[n.name.lower()].name
                for n in self.graph.order
                if isinstance(n, node_class) and n.name.lower() in self._traces]

    # -- visibility --------------------------------------------------------------

    def is_visible(self, name):
        t = self[name]
        return t.is_visible() if t is not None else False

    def set_visible(self, name, show):
        t = self[name]
        if t is None:
            return False
        changed = t.is_visible() != show
        t.set_visible(show)
        return changed

    def set_need_update(self):
        """Reference-API shim: laziness is recomputed per update from the
        visible set (`src/audian/data.py:213-222`)."""
        return self.visible_traces()

    def visible_traces(self):
        return [t.name for t in self.traces if t.is_visible()]

    # -- lifecycle ----------------------------------------------------------------

    def open(self, unwrap=0.0, unwrap_clip=False):
        from .. import enable_compilation_cache

        enable_compilation_cache()
        if self.data is not None:
            self.data.close()
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        self._q_staging.clear()  # shapes belong to the previous recording
        self.data = AudioLoader(
            self.file_path,
            buffer_time=self.buffer_time,
            back_time=self.back_time,
            **self.load_kwargs,
        )
        if unwrap or unwrap_clip:
            thresh = unwrap if unwrap else 1.5
            self.data.set_unwrap(thresh, bool(unwrap_clip))
        self.data.follow = int(self.follow_time * self.data.rate)
        self._raw = RawTrace(self.data)
        self.file_path = self.data.filepath
        self.rate = self.data.rate
        self.channels = self.data.channels
        self.frames = self.data.frames
        self.meta_data = dict(Format=self.data.format_dict())
        self.meta_data.update(self.data.metadata())
        self.start_time = wavio.get_datetime(self.meta_data)
        self._reopen_graph(reset=True)
        return self

    def _reopen_graph(self, reset=False):
        """Re-derive node specs and the executor.  ``reset`` (a fresh
        ``open()``) also wipes reused Trace windows — the new open can
        have different decode semantics (unwrap) or another file, and a
        kept window would serve the previous session's data; add/remove
        of traces mid-session keeps the existing windows instead."""
        self.tbefore, self.tafter = self.graph.open(self._raw.spec)
        self.executor = GraphExecutor(self.graph)
        new = {}
        for node in self.graph.order:
            key = node.name.lower()
            tr = self._traces.get(key) or Trace(node, self)
            tr._node = node
            if reset:
                tr.offset = 0
                tr.buffer = np.zeros((0,), np.float32)
                tr.buffer_changed = np.zeros(node.spec.channels,
                                             dtype=bool)
                if len(tr.plot_items) != node.spec.channels:
                    tr.plot_items = [None] * node.spec.channels
            new[key] = tr
        self._traces = new
        if reset:
            self._dirty.clear()
        # buffer sizing happens lazily per update window
        self._resize_raw_buffer()

    def _resize_raw_buffer(self):
        if self.data is None:  # updates on a closed Data are no-ops
            return
        tbuffer = self.buffer_time + self.tbefore + self.tafter
        tback = self.back_time + self.tbefore
        self.data.bufferframes = int(tbuffer * self.data.rate)
        self.data.backframes = int(tback * self.data.rate)

    def close(self):
        if self.data is not None:
            self.data.close()
            self.data = None
        self._dev_raw = None
        self._dev_raw_off = None
        self._last_raw_shift = None
        self._q_staging.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- updates ------------------------------------------------------------------

    def _descendants(self, name):
        """The updated node and every trace downstream of it."""
        out = {name.lower()}
        for n in self.graph.order:
            if n.source_name.lower() in out:
                out.add(n.name.lower())
        return out

    def _after_update(self, name, geometry_changed=False):
        if geometry_changed and self.data is not None:
            # re-derive downstream output specs (safe: node.open keeps
            # user parameters on re-open)
            self.graph.open(self._raw.spec)
        # traces downstream of the change hold stale content until their
        # next recompute; hidden ones are skipped below, and the dirty
        # mark keeps the scroll fast path from serving them after they
        # are shown again
        self._dirty |= self._descendants(name)
        # bump the VALUE generation of every affected trace: render-side
        # caches may reuse window content across scrolls (same global
        # frames -> same values, the chunked==whole invariant) but must
        # refetch after any parameter change
        for n in self._descendants(name):
            self._content_epoch[n] = self._content_epoch.get(n, 0) + 1
        self.tbefore, self.tafter = self.graph.refold()
        self._resize_raw_buffer()
        self._recompute_buffer()

    def _put_raw(self, hbuf, gstart=None):
        """Upload a host raw-window slice to the device.

        16-bit sources (PCM-16 WAV, 16-bit FLAC) cross the link as
        int16 — half the bytes — and dequantize on device.
        This is exact: every PCM-16 sample is k/2^15, representable
        bit-identically along both paths.  Unwrapped data halves sample
        values (k/2^16), so unwrap keeps the f32 upload.

        With ``gstart`` (the slice's global frame offset) the int16
        staging is read straight from the files via the loader's raw16
        path — the pages are warm in the OS cache from the window load
        the slice mirrors, and it skips three quantize passes over the
        f32 data — into a recycled per-shape staging buffer (fresh pages
        cost ~100x on this host).
        """
        put = self._device_put
        infos = getattr(self.data, "_infos", None)
        # 16-bit sources: PCM-16 WAV and 16-bit FLAC both store k/2^15
        # codes (the loader's raw16 convention), so both take the
        # half-the-bytes int16 upload
        all_i16 = bool(infos) and all(i[3] in ("PCM_16", "FLAC_16")
                                      for i in infos)
        if (hbuf.dtype == np.float32 and all_i16
                and getattr(self.data, "unwrap_thresh", 0.0) <= 1e-3):
            if gstart is not None and getattr(self.data, "raw16_capable",
                                              False):
                # small LRU of per-shape staging buffer PAIRS
                # (pop+reinsert keeps the hit most-recent in dict
                # order).  Two buffers in rotation per shape: a
                # device_put may read its host source asynchronously
                # (and aliases it outright on the CPU backend), so the
                # buffer of upload N is only reused at upload N+2 — by
                # then upload N's dequant has executed (device work runs
                # in order and upload N+1's render pull fenced it)
                bucket = self._q_staging.pop(hbuf.shape, None)
                if bucket is None:
                    bucket = deque(maxlen=2)
                self._q_staging[hbuf.shape] = bucket
                while len(self._q_staging) > 4:
                    self._q_staging.pop(next(iter(self._q_staging)))
                q = (bucket.popleft() if len(bucket) == 2
                     else np.empty(hbuf.shape, np.int16))
                bucket.append(q)
                self.data.read_raw16_into(int(gstart), len(hbuf), q)
                return _dequant16(put(q))
            q = np.round(np.ascontiguousarray(hbuf) * 32768.0
                         ).astype(np.int16)
            return _dequant16(put(q))
        return put(np.ascontiguousarray(hbuf))

    def _device_put(self, array):
        """``jax.device_put`` honoring the optional channel mesh: with a
        mesh whose "ch" axis divides the channel count, the window lands
        channel-sharded and XLA propagates that sharding through every
        derived-window and render-tile program (zero collectives — the
        chain is channel-independent)."""
        if self.mesh is not None and array.ndim >= 2 \
                and "ch" in self.mesh.shape \
                and array.shape[1] % self.mesh.shape["ch"] == 0:
            from jax.sharding import NamedSharding, PartitionSpec

            spec = PartitionSpec(*([None, "ch"]
                                   + [None] * (array.ndim - 2)))
            return jax.device_put(array, NamedSharding(self.mesh, spec))
        return jax.device_put(array)

    def _device_raw(self):
        """Device mirror of the loader's host window.

        Re-uploading the whole 60 s buffer per scroll (~180 MB at 8
        channels) would move the full window each time; instead the device
        copy slides in place and only the newly exposed frames (bucketed
        to a power of two, a few MB) cross the link — the device-side
        twin of the reference's ``move_buffer`` retention
        (`src/audian/buffereddata.py:75-109`, SURVEY.md section 5.7)."""
        gen = self._dev_gen
        buf = self.data.buffer
        off = int(self.data.offset)
        cap = len(buf)
        old = self._dev_raw
        self._last_raw_shift = None
        shift_note = None
        if old is None or old.shape[0] != cap or self._dev_raw_off is None:
            new_dev = self._put_raw(buf, off)
        else:
            shift = off - self._dev_raw_off
            if shift == 0:
                new_dev = old
                shift_note = 0
            elif abs(shift) >= cap:
                new_dev = self._put_raw(buf, off)
            else:
                nb = min(_pow2ceil(abs(shift)), cap)
                if shift > 0:
                    new = buf[cap - nb :]
                    g0 = off + cap - nb
                else:
                    new = buf[:nb]
                    g0 = off
                new_dev = _slide_window(old, self._put_raw(new, g0),
                                        shift, tail=shift > 0)
                shift_note = shift
        if gen != self._dev_gen:
            # a host-mode flip happened while this (abandoned watchdog)
            # thread was blocked in an upload: the loader buffer slid
            # on without us — committing would mislabel the mirror
            raise DeviceLost("device mirror invalidated during upload")
        self._dev_raw = new_dev
        self._dev_raw_off = off
        self._last_raw_shift = shift_note
        return new_dev

    def _try_delta_update(self, dev, targets):
        """Scroll fast path: recompute only a halo-extended sub-window
        covering the newly exposed frames and stitch it into the sliding
        device trace windows — the reference's incremental
        ``load_buffer`` (`src/audian/buffereddata.py:91-109`) as two tiny
        device programs instead of a full-window chain run.

        Returns True when the stitch was applied; False falls back to the
        full-window recompute (startup, geometry changes, big jumps)."""
        gen = self._dev_gen
        rs = self._last_raw_shift
        if rs is None:
            return False
        off = int(self.data.offset)
        cap = dev.shape[0]
        active = self.graph.active_set(targets)
        plan, _ = self.executor._plan(off, cap, active)
        old = {}
        for name, g in plan.items():
            tr = self._traces.get(name)
            if tr is None:
                continue
            if (not isinstance(tr.buffer, jax.Array)
                    or len(tr.buffer) != g.n_out
                    or name in self._dirty):
                return False  # geometry changed / stale -> full recompute
            old[name] = (tr, g)
        if rs == 0:
            # window unchanged; offsets must also be current (a trace
            # re-shown after the raw window moved can have matching
            # length at a stale offset)
            return all(tr.offset == g.o0 for tr, g in old.values())
        # sub-window: the new frames plus the graph's halo fold, bucketed
        fold = int((self.tbefore + self.tafter) * self.rate) + 8192
        W = _pow2ceil(abs(rs) + fold)
        if W >= cap:
            return False
        a = cap - W if rs > 0 else 0
        sub = _dev_slice(dev, a, W)
        out = self.executor.run(sub, off + a, targets=targets, device=True)
        # every tracked trace must have produced output: a sub-window
        # shorter than a node's geometry (e.g. huge NFFT vs a small
        # scroll) yields no frames for it, and skipping the patch would
        # freeze that trace's window at a stale offset for every
        # following scroll
        produced = {n for n in out if n != RAW}
        if any(name not in produced for name in old):
            return False
        patches = []
        for name, (o0s, arr) in out.items():
            if name == RAW or name not in old:
                continue
            tr, g = old[name]
            shift = g.o0 - tr.offset
            pos = o0s - g.o0
            # the patch must land inside the new window and fully cover
            # the region the slide invalidates (the window's new edge)
            if pos < 0 or pos + len(arr) > g.n_out:
                return False
            if shift > 0 and pos + len(arr) < g.n_out:
                return False
            if shift < 0 and pos > 0:
                return False
            if abs(shift) > len(arr):
                return False
            patches.append((tr, g, arr, shift, pos))
        if gen != self._dev_gen:
            # abandoned watchdog thunk unblocked after a host-mode flip:
            # committing would overwrite host windows with stale patches
            raise DeviceLost("trace windows invalidated during update")
        for tr, g, arr, shift, pos in patches:
            tr._set_window(g.o0, _slide_patch(tr.buffer, arr, shift, pos))
        return True

    def _refresh_trace(self, name):
        """Recompute one dirty (hidden) trace's window in place, so reads
        through :meth:`Trace._range` are served from the refreshed buffer
        instead of paying a fresh device program per access.  Same chunk
        geometry as the last scroll — always a compile cache hit.  Returns
        False when there is no raw window to compute from."""
        if self.data is None or len(self.data.buffer) == 0:
            return False
        try:
            def work():
                dev = self._device_raw()
                return self.executor.run(dev, self.data.offset,
                                         targets=[name], device=True)

            out = _devwatch.pull(work, what=f"refresh {name}")
        except DeviceLost:
            self._host_windows(targets=[name])
            return name.lower() not in self._dirty
        for n, (off, arr) in out.items():
            if n != RAW and n in self._traces:
                self._traces[n]._set_window(off, arr)
        self._dirty.difference_update(out)
        return name.lower() in out

    def _recompute_buffer(self):
        """Re-run the fused program over the raw buffer already in memory —
        the parameter-change hot path (`src/audian/buffereddata.py:149-153`
        recompute_all analog).  Same chunk geometry as the last scroll, so
        this is always a cache hit."""
        if self.data is None or len(self.data.buffer) == 0:
            return
        visible = self.visible_traces()
        targets = [n for n in visible if n != RAW] or None
        if not targets:
            return
        try:
            self._device_windows(targets)
        except DeviceLost:
            self._host_windows(targets)

    def buffered_region(self):
        """Interior (halo-excluded) window currently buffered, in seconds —
        the range parameter changes recompute over."""
        if self.data is None or len(self.data.buffer) == 0:
            return (0.0, 0.0)
        t0 = self.data.offset / self.data.rate + self.tbefore
        t1 = ((self.data.offset + len(self.data.buffer)) / self.data.rate
              - self.tafter)
        return (min(t0, t1), t1)

    def update_times(self, t0, t1):
        """Move the shown window to [t0, t1]: fetch raw with halos, run the
        fused device program for all visible traces, refresh the host
        windows (`src/audian/data.py:225-236` + the per-trace
        ``load_buffer`` cascade, all in one device launch)."""
        if self.data is None:
            return None
        visible = self.visible_traces()
        targets = [n for n in visible if n != RAW] or None
        self.data.update_time(max(t0 - self.tbefore, 0.0),
                              min(t1 + self.tafter, self.frames / self.rate))
        if targets:
            try:
                self._device_windows(targets)
            except DeviceLost:
                # dead device: serve this window from the host
                # scipy path — the session degrades, it never hangs.
                # Only the visible span (+ graph halos) is recomputed.
                g0 = int(max(t0 - self.tbefore, 0.0) * self.rate)
                g1 = int(math.ceil((t1 + self.tafter) * self.rate))
                self._host_windows(targets, span=(g0, g1))
        self._raw.buffer_changed[:] = True
        i0 = min(int(t0 * self.data.rate), self.data.frames - 1)
        fp, _ = self.data.get_file_index(i0)
        return self.data.basename(fp)

    def _device_windows(self, targets):
        """The guarded device section of :meth:`update_times`: upload /
        slide the raw mirror, then recompute (or delta-stitch) the
        visible windows in one device launch.  Runs under the
        device-loss watchdog — raises :class:`DeviceLost` instead of
        hanging when the device stops answering (`utils/devicewatch.py`)."""

        def work():
            dev = self._device_raw()
            if self._try_delta_update(dev, targets):
                return None
            return self.executor.run(dev, self.data.offset,
                                     targets=targets, device=True)

        # outputs stay on the device; host code pulls only the slices
        # it renders (min/max tiles, dB tiles), not whole traces
        out = _devwatch.pull(work, what="window update")
        if out is not None:
            for name, (off, arr) in out.items():
                if name == RAW:
                    continue
                self._traces[name]._set_window(off, arr)
            self._dirty.difference_update(out)
        if self._host_mode:
            # back on device after a host-mode stretch: bump the value
            # generations so render caches never mix host (f64 scipy)
            # and device (f32) tiles of the same frames
            self._host_mode = False
            for n in list(self._content_epoch):
                self._content_epoch[n] += 1

    def _host_windows(self, targets=None, span=None):
        """Device-loss fallback: recompute the visible trace windows
        from the loader's HOST buffer through the nodes' scipy twins
        (`GraphExecutor.run_host`) — numpy windows the render layer's
        host branches consume without touching the device.  Bumps the
        content epochs on the mode transition (host f64 values differ
        from device f32 at ~1e-5; caches must not mix them).

        ``span`` (absolute raw frames ``(g0, g1)``, already
        halo-widened) restricts the recompute to a sub-window — the
        scroll path passes the visible span so a host-mode scroll costs
        the view width, not the whole 60 s buffer (the full window is the default for untargeted refreshes)."""
        if self.data is None or len(self.data.buffer) == 0:
            return
        if targets is None:
            targets = [n for n in self.visible_traces() if n != RAW]
            if not targets:
                return
        off = int(self.data.offset)
        buf = self.data.buffer
        if span is not None:
            g0 = max(int(span[0]), off)
            g1 = min(int(span[1]), off + len(buf))
            if g1 > g0:
                buf = buf[g0 - off : g1 - off]
                off = g0
        out = self.executor.run_host(buf, off, targets=targets)
        for name, (o, arr) in out.items():
            if name != RAW and name in self._traces:
                self._traces[name]._set_window(o, arr)
        self._dirty.difference_update(out)
        if not self._host_mode:
            self._host_mode = True
            for n in self._descendants(RAW) | set(out):
                self._content_epoch[n] = self._content_epoch.get(n, 0) + 1
        # a later device recompute must re-upload the full window: the
        # device mirror went stale while the session scrolled host-side
        # (the gen bump also stops abandoned watchdog thunks from
        # resurrecting it when the device answers again)
        self._dev_raw = None
        self._dev_raw_off = None
        self._dev_gen += 1

    #: on-demand ranges are quantized (aligned start, power-of-two length)
    #: so repeated region queries reuse a handful of compiled programs
    _range_align = 1 << 12

    def _quantized_raw_window(self, r0, r1):
        """Widen raw frames [r0, r1) by the graph halos to an aligned
        start and power-of-two length (one compiled program serves every
        similar-sized region query)."""
        hb = int(math.ceil(self.tbefore * self.rate))
        ha = int(math.ceil(self.tafter * self.rate))
        a = self._range_align
        q0 = max(((r0 - hb) // a) * a, 0)
        want = r1 + ha - q0
        # the shared bucketing rule (utils.pow2_at_least), floored at
        # one alignment unit — a private copy here could drift
        n = max(_pow2ceil(want), a)
        if q0 + n > self.frames:
            q0 = max(0, ((self.frames - n) // a) * a)
            n = min(n, self.frames - q0)
        return q0, n

    def _compute_range(self, name, start, stop, targets=None):
        """On-demand computation of an arbitrary output range of one trace
        (serves region analysis/export without moving the view window).

        The request is widened to a quantized raw window first — compile
        once, then every region query of similar size is a re-run.
        """
        node = self.graph[name]
        if node is None:
            raise KeyError(name)
        # widen the request in raw-frame space to a quantized window
        step_total = round(self.rate / node.spec.rate)
        q0, n = self._quantized_raw_window(start * step_total,
                                           stop * step_total)
        raw = self.data._read(q0, n)
        try:
            out = _devwatch.pull(
                lambda: self.executor.run(raw, q0,
                                          targets=targets or [name],
                                          device=False),
                what=f"compute {name}")
        except DeviceLost:
            out = self.executor.run_host(raw, q0,
                                         targets=targets or [name])
        off, arr = out[name.lower()]
        lo = start - off
        if lo < 0 or lo + (stop - start) > len(arr):
            raise IndexError(
                f"{name}: frames [{start}, {stop}) not computable "
                f"(produced [{off}, {off + len(arr)}))"
            )
        return arr[lo : lo + (stop - start)]

    # -- regions -------------------------------------------------------------------

    def get_region(self, t0, t1, channel):
        """Time-sliced arrays of all traces for a selected region
        (`src/audian/data.py:102-118` semantics: i1 is inclusive+1,
        spectrogram traces add their frequency axis).

        All derived traces come from ONE fused device run over a quantized
        raw window (the reference loops per trace on the host).
        """
        derived = [n.name for n in self.graph.order]
        computed = {}
        if derived:
            finest = max(self.traces[1:], key=lambda t: t.rate, default=None)
            if finest is not None:
                i0 = max(int(t0 * finest.rate), 0)
                i1 = min(int(t1 * finest.rate) + 1, len(finest))
                computed = self._compute_region(derived, i0, i1, finest.rate)
        out = {}
        for t in self.traces:
            i0 = max(int(t0 * t.rate), 0)
            i1 = min(int(t1 * t.rate) + 1, len(t))
            time = np.arange(i0, i1) / t.rate
            if t.name in computed:
                off, arr = computed[t.name]
                lo = i0 - off
                if 0 <= lo and lo + (i1 - i0) <= len(arr):
                    data = arr[lo : lo + (i1 - i0), channel]
                else:
                    data = t[i0:i1, channel]
            else:
                data = t[i0:i1, channel]
            if isinstance(getattr(t, "_node", None), SpectrogramNode):
                out[t.name] = (time, t.frequencies, data)
            else:
                out[t.name] = (time, data)
        return out

    def _compute_region(self, names, i0, i1, rate):
        """One quantized fused run producing all ``names`` over a window
        covering frames [i0, i1) at ``rate``."""
        q0, n = self._quantized_raw_window(
            int(i0 * self.rate / rate),
            int(math.ceil(i1 * self.rate / rate)))
        raw = self.data._read(q0, n)
        try:
            out = _devwatch.pull(
                lambda: self.executor.run(raw, q0, targets=names,
                                          device=False),
                what="compute region")
        except DeviceLost:
            out = self.executor.run_host(raw, q0, targets=names)
        return {self._traces[k]._node.name if k in self._traces else k: v
                for k, v in out.items() if k != RAW}


def default_traces():
    """The full demo chain (filter + envelope + spectrogram) used by the
    tests and the library examples.  NOTE: the browser's default plugin
    set installs only filter + spectrogram, like the reference's
    ``default_setup_traces`` (`src/audian/plugins.py:11-13`) — there the
    envelope is a plugin/CLI opt-in."""
    return [
        FilterNode("filtered", "data"),
        EnvelopeNode("envelope", "filtered"),
        SpectrogramNode("spectrogram", "filtered"),
    ]
