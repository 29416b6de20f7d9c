"""Device-side render tiles: min/max trace decimation and dB image tiles.

The reference decimates the visible window to per-pixel min/max pairs on
the host per redraw (`src/audian/traceitem.py:33-82`) and converts
spectrogram power to dB on upload (`src/audian/specitem.py:33-39`).  Here
both are tiny jitted device programs over the (device-resident) trace
windows; only the pixel-sized tile crosses to the host.

Every entry point is shape-bucketed: steps snap to powers of two and tile
widths are fixed, so interactive zooming reuses a handful of compiled
programs (on this backend each uncompiled eager op costs ~seconds through
the compile path, so nothing here dispatches eagerly).
"""

from __future__ import annotations

import functools
import math
import weakref

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import trace as _trace
from ..utils import pow2_at_least as _pow2_at_least
from ..utils.devicewatch import DeviceLost, watch as _devwatch

__all__ = ["TraceTiler", "SpecTiler", "pick_amplitude"]


def _to_host_mode(trace, t0=None, t1=None, targets=None):
    """Switch ``trace`` (and its siblings) to host-computed numpy
    windows after a mid-render device loss; True when the window is now
    host-resident so the caller can retry its host branch.

    ``t0``/``t1`` (seconds) restrict the scipy float64 recompute to the
    visible span plus the session halos — the same restriction
    ``Data.update_times``'s own loss path applies, because a full-buffer
    recompute of every visible trace costs the whole buffer on the host
    where the span costs ~the view width.  Without a span
    (or when the raw loader is gone) the full window is recomputed.
    ``targets`` restricts the recompute to named traces (a one-off
    readout like a hover must not truncate every OTHER visible trace's
    window to its tiny span — the siblings flip to host mode with their
    own spans when their next render touches them)."""
    data = getattr(trace, "_data", None)
    if data is None:
        return False
    span = None
    if t0 is not None and t1 is not None and data.data is not None:
        r = data.data.rate
        g0 = int(max(t0 - data.tbefore, 0.0) * r)
        g1 = int(math.ceil((t1 + data.tafter) * r))
        if g1 > g0:
            span = (g0, g1)
    data._host_windows(targets=targets, span=span)
    return not isinstance(trace.buffer, jax.Array)


def _host_minmax_tile(seg, step, width):
    """Numpy twin of :func:`_minmax_tile` over a host window slice."""
    shaped = np.asarray(seg).reshape((width, step) + seg.shape[1:])
    tile = np.stack([shaped.min(axis=1), shaped.max(axis=1)], axis=1)
    return tile.reshape((2 * width,) + seg.shape[1:]).astype(
        np.float32, copy=False)


@functools.partial(jax.jit, static_argnames=("step", "width"))
def _minmax_tile(buf, start, step, width):
    """Interleaved min/max of ``width`` segments of ``step`` frames
    starting at ``start`` (buffer-relative, traced)."""
    seg = jax.lax.dynamic_slice_in_dim(buf, start, width * step, axis=0)
    shaped = seg.reshape((width, step) + buf.shape[1:])
    mins = jnp.min(shaped, axis=1)
    maxs = jnp.max(shaped, axis=1)
    tile = jnp.stack([mins, maxs], axis=1)
    return tile.reshape((2 * width,) + buf.shape[1:])


@functools.partial(jax.jit, static_argnames=("width",))
def _slice_tile(buf, start, width):
    return jax.lax.dynamic_slice_in_dim(buf, start, width, axis=0)


def _pack_scaled_i16(tile):
    """Quantize a ``(n, channels)`` f32 tile to int16 with a per-channel
    scale bit-packed into the first two rows — one int16 transfer instead
    of an f32 one (render tiles only need ~1e-4 relative accuracy)."""
    scale = jnp.maximum(jnp.max(jnp.abs(tile), axis=0), 1e-30)
    q = jnp.clip(jnp.round(tile * (32767.0 / scale)),
                 -32768, 32767).astype(jnp.int16)
    head = jax.lax.bitcast_convert_type(scale.astype(jnp.float32),
                                        jnp.int16)   # (channels, 2)
    return jnp.concatenate([head.T, q], axis=0)


def _unpack_scaled_i16(packed):
    """Host-side inverse of :func:`_pack_scaled_i16`."""
    head = np.ascontiguousarray(packed[:2].T)        # (channels, 2) int16
    scale = head.view(np.float32).reshape(-1)        # (channels,)
    return packed[2:].astype(np.float32) * (scale / 32767.0)


@functools.partial(jax.jit, static_argnames=("step", "width"))
def _minmax_tile_i16(buf, start, step, width):
    return _pack_scaled_i16(_minmax_tile.__wrapped__(buf, start, step,
                                                     width))


@functools.partial(jax.jit, static_argnames=("width",))
def _slice_tile_i16(buf, start, width):
    return _pack_scaled_i16(
        jax.lax.dynamic_slice_in_dim(buf, start, width, axis=0))


def _delta_columns(cache, key, trace, buf, g0, w, unit, r, fetch, hi_g,
                   max_entries=32):
    """Tile-column cache with scroll-delta reuse.

    Returns ``w`` decoded columns starting at GLOBAL frame ``g0`` (one
    column = ``unit`` frames, ``r`` output rows per column).  Columns
    overlapping the cached previous request of the same ``key`` are
    copied host-side; only missing columns cross the host link through
    ``fetch(global_start, ncolumns)`` (bucketed widths, a handful of
    compiled shapes).  Content identity across window objects comes from
    ``trace.content_epoch`` — scrolling keeps it (same global frames ->
    same values, the chunked==whole invariant), parameter changes bump
    it; objects without an epoch fall back to buffer identity, i.e. the
    pre-delta behavior.  ``hi_g`` is the (global) end of the loaded
    window; partial reuse requires the request inside it."""
    epoch = getattr(trace, "content_epoch", None)
    g1 = g0 + w * unit
    hit = cache.get(key)
    # hit["trace"]() is trace guards the id(trace) in the key: CPython
    # recycles addresses, so a freed Trace's cache entry must never
    # serve a new Trace that landed on the same id
    fresh = hit is not None and hit["trace"]() is trace and (
        (epoch is not None and hit["epoch"] == epoch)
        or (epoch is None and hit["buf"]() is buf))
    if fresh and hit["g0"] <= g0 and g1 <= hit["g1"]:
        a = (g0 - hit["g0"]) // unit
        return hit["data"][r * a : r * (a + w)]
    if fresh and hit["g0"] < g1 and g0 < hit["g1"] and g1 <= hi_g:
        c0, c1, old = hit["g0"], hit["g1"], hit["data"]
        tile = np.empty((r * w,) + old.shape[1:], old.dtype)
        a = (max(g0, c0) - g0) // unit
        b = (min(g1, c1) - g0) // unit
        s = (max(g0, c0) - c0) // unit
        tile[r * a : r * b] = old[r * s : r * s + r * (b - a)]
        if g0 < c0:  # scrolled left: new columns before the cache
            need = (c0 - g0) // unit
            wc = min(_pow2_at_least(need), w)
            tile[: r * need] = fetch(g0, wc)[: r * need]
        if c1 < g1:  # scrolled right: new columns after the cache
            need = (g1 - c1) // unit
            wc = min(_pow2_at_least(need), w)
            tile[r * (w - need):] = fetch(g1 - wc * unit,
                                          wc)[r * (wc - need):]
    else:
        tile = fetch(g0, w)
    if key not in cache and len(cache) >= max_entries:
        cache.clear()
    cache[key] = {"epoch": epoch, "buf": weakref.ref(buf),
                  "trace": weakref.ref(trace),
                  "g0": g0, "g1": g1, "data": tile}
    return tile


class TraceTiler:
    """Min/max decimation of a windowed trace to screen pixels.

    Reference semantics (`src/audian/traceitem.py:36-82`): ``step =
    (visible frames)//max_pixels`` floored at 1; segment starts aligned to
    step multiples; interleaved min/max values plotted at half-step times.
    Steps are bucketed to powers of two here so zoom levels share compiled
    programs (the visual result is identical at sub-pixel scale).
    """

    def __init__(self, max_pixels=1920, quantize=True):
        self.max_pixels = int(max_pixels)
        #: pull tiles as scale-packed int16 (half the pulled bytes; ~1e-4
        #: relative quantization, invisible at screen resolution).  Off
        #: for callers needing bit-exact buffer values.
        self.quantize = bool(quantize)
        # the device tile covers ALL channels; per-channel callers (one
        # plot item each) reuse one compute + one host pull per window.
        # Entries additionally carry their GLOBAL column coverage, so a
        # scroll (new window object, same trace values — guaranteed by
        # the chunked==whole invariant, invalidated per parameter change
        # through Trace.content_epoch) re-pulls only the newly exposed
        # columns over the slow host link.
        self._cache = {}

    def _columns(self, trace, buf, boff, step, g0, w, minmax):
        """Decoded tile columns for ``w`` segments of ``step`` frames
        starting at GLOBAL frame ``g0`` (on the ``g0 % step`` grid,
        fully inside the loaded window).  Overlapping columns come from
        the previous pull of the same trace at the same geometry; only
        missing columns cross the host link (bucketed widths, so scrolls
        reuse a handful of compiled shapes)."""
        if not isinstance(buf, jax.Array):
            # host-mode window (device lost): the same tile math in
            # numpy, no quantized transfer (there is no transfer)
            def fetch(gs, wc):
                a = gs - boff
                seg = np.asarray(buf[a : a + wc * (step if minmax else 1)])
                if minmax:
                    return _host_minmax_tile(seg, step, wc)
                return seg.astype(np.float32, copy=False)

            key = ("host_minmax" if minmax else "host_slice", id(trace),
                   step, g0 % step)
            return _delta_columns(
                self._cache, key, trace, buf, g0, w, step,
                2 if minmax else 1, fetch, boff + len(buf))
        if minmax:
            kernel = _minmax_tile_i16 if self.quantize else _minmax_tile
        else:
            kernel = _slice_tile_i16 if self.quantize else _slice_tile
        post = _unpack_scaled_i16 if self.quantize else None

        def fetch(gs, wc):
            args = ((gs - boff, step, wc) if minmax
                    else (gs - boff, wc))
            raw = _devwatch.pull(lambda: np.asarray(kernel(buf, *args)),
                                 what="render tile")
            _trace.trace_event("render.pull", op=kernel.__name__,
                               bytes=raw.nbytes)
            return raw if post is None else post(raw)

        key = (kernel.__name__, id(trace), step, g0 % step)
        return _delta_columns(
            self._cache, key, trace, buf, g0, w, step,
            2 if minmax else 1, fetch, boff + len(buf))

    def tile(self, trace, t0, t1, channel=None):
        """Render tile for view range [t0, t1].

        Parameters
        ----------
        trace : object with ``rate, frames, offset, buffer`` (a
            :class:`audian_tpu.data.Data` trace view).
        channel : channel to extract; None returns all channels.

        Returns ``(times, values)`` numpy arrays; for ``step > 1`` values
        are interleaved min/max at half-step positions.

        A device loss mid-render switches the trace's windows to the
        host scipy path and re-renders from there — a dead device costs
        one watchdog timeout, never a hang.
        """
        try:
            return self._tile(trace, t0, t1, channel)
        except DeviceLost:
            if _to_host_mode(trace, t0, t1):
                return self._tile(trace, t0, t1, channel)
            raise

    def _tile(self, trace, t0, t1, channel=None):
        rate = trace.rate
        start = max(0, int(t0 * rate))
        tstop = int(t1 * rate + 1)
        stop = min(trace.frames, tstop)
        if stop <= start:
            shape = (0,) if channel is not None else (0, trace.channels)
            return np.zeros(0), np.zeros(shape, np.float32)
        step = max(1, (tstop - start) // self.max_pixels)
        buf = trace.buffer
        boff = trace.offset
        if step > 1:
            step = _pow2_at_least(step)
            start = (start // step) * step
            # clamp into the loaded window, step-aligned
            lo = boff + ((-boff) % step) if boff % step else boff
            while start < lo:
                start += step
            stop = min(stop, boff + len(buf))
            width = max((stop - start) // step, 0)
            if width == 0:
                shape = (0,) if channel is not None else (0, trace.channels)
                return np.zeros(0), np.zeros(shape, np.float32)
            # bucket the tile width (arbitrary widths would compile per
            # scroll) and
            # shift the slice back so the padded tile stays in the buffer
            avail = (boff + len(buf) - lo) // step
            wb = min(_pow2_at_least(width), avail)
            start2 = min(start, boff + len(buf) - wb * step)
            start2 = lo + ((start2 - lo) // step) * step
            tile = self._columns(trace, buf, boff, step, start2, wb,
                                 minmax=True)
            k0 = (start - start2) // step
            values = tile[2 * k0 : 2 * (k0 + width)]
            half = step / 2
            times = (start + np.arange(2 * width) * half) / rate
        else:
            start = max(start, boff)
            stop = min(stop, boff + len(buf))
            width = max(stop - start, 0)
            wb = min(_pow2_at_least(width), len(buf))
            start2 = max(min(start, boff + len(buf) - wb), boff)
            values = self._columns(trace, buf, boff, 1, start2, wb,
                                   minmax=False)
            values = values[start - start2 : start - start2 + width]
            times = (start + np.arange(width)) / rate
        if channel is not None:
            values = values[:, channel]
        return times, values


def pick_amplitude(trace, t, y, t1=None, channel=0):
    """Nearest-extremum amplitude at cursor position — used by the
    crosshair snap (`src/audian/traceitem.py:85-104` semantics)."""
    rate = trace.rate
    idx = int(round(t * rate))
    step = 1
    if t1 is not None:
        step = max(1, int(round(t1 * rate)) - idx)
    if step > 1:
        idx = (idx // step) * step
        block = np.asarray(trace[idx : idx + step, channel])
        if block.size == 0:
            return idx / rate, 0.0
        mini = int(np.argmin(block))
        maxi = int(np.argmax(block))
        amin, amax = float(block[mini]), float(block[maxi])
        if abs(y - amax) < abs(y - amin):
            return (idx + maxi) / rate, amax
        return (idx + mini) / rate, amin
    idx = min(max(idx, 0), trace.frames - 1)
    return idx / rate, float(np.asarray(trace[idx, channel]))


@functools.partial(jax.jit, static_argnames=("wb",))
def _window_extrema(buf, start, offset, width, wb):
    """Per-channel (min, max) of ``width`` frames at ``start + offset``,
    reduced over a bucketed ``wb``-frame slice with masking — the
    auto-scale reduction (`src/audian/timeplot.py:111-123`) computed on
    device so only ``(2, channels)`` floats cross the host link.  Offset
    and width are traced: one compiled program per bucket serves every
    scroll position and zoom."""
    part = jax.lax.dynamic_slice_in_dim(buf, start, wb, axis=0)
    k = jnp.arange(wb)[:, None]
    mask = (k >= offset) & (k < offset + width)
    mins = jnp.min(jnp.where(mask, part, jnp.inf), axis=0)
    maxs = jnp.max(jnp.where(mask, part, -jnp.inf), axis=0)
    return jnp.stack([mins, maxs])


_extrema_cache = {}


def window_extrema(trace, t0, t1, channel):
    """(min, max) of ``trace`` on ``channel`` over [t0, t1] seconds.

    Device-resident windows reduce on device (cached per window object
    and range, all channels in one pull); host windows fall back to
    numpy.
    """
    rate = trace.rate
    i0 = max(int(t0 * rate) - trace.offset, 0)
    i1 = min(int(t1 * rate) - trace.offset, len(trace.buffer))
    if i1 <= i0:
        return 0.0, 0.0
    buf = trace.buffer
    if not isinstance(buf, jax.Array):
        part = np.asarray(buf[i0:i1, channel])
        return float(part.min()), float(part.max())
    width = i1 - i0
    wb = min(_pow2_at_least(width), len(buf))
    start = max(min(i0, len(buf) - wb), 0)
    key = (id(buf), start, i0, width, wb)
    hit = _extrema_cache.get(key)
    if hit is None or hit[0]() is not buf:
        try:
            stats = _devwatch.pull(
                lambda: np.asarray(_window_extrema(buf, start,
                                                   i0 - start, width, wb)),
                what="window extrema")
        except DeviceLost:
            if not _to_host_mode(trace, t0, t1):
                raise
            # the span-limited host recompute moved trace.offset —
            # re-derive the window-relative indices before reading
            i0 = max(int(t0 * rate) - trace.offset, 0)
            i1 = min(int(t1 * rate) - trace.offset, len(trace.buffer))
            if i1 <= i0:
                return 0.0, 0.0
            part = np.asarray(trace.buffer[i0:i1, channel])
            return float(part.min()), float(part.max())
        _trace.trace_event("render.pull", op="window_extrema",
                           bytes=stats.nbytes)
        for k in [k for k, v in _extrema_cache.items() if v[0]() is None]:
            _extrema_cache.pop(k, None)
        if len(_extrema_cache) > 64:
            _extrema_cache.clear()
        hit = (weakref.ref(buf), stats)
        _extrema_cache[key] = hit
    stats = hit[1]
    return float(stats[0, channel]), float(stats[1, channel])


@functools.partial(jax.jit, static_argnames=("wb",))
def _power_block(buf, start, channel, wb):
    part = jax.lax.dynamic_slice_in_dim(buf, start, wb, axis=0)
    return jax.lax.dynamic_index_in_dim(part, channel, axis=1,
                                        keepdims=False)


_power_block_cache = {}

#: frames per cached hover block (pow2 so compiled shapes stay bounded)
_POWER_BLOCK = 256


def power_value(trace, i, channel, j):
    """Linear power of one spectrogram cell (buffer-relative frame ``i``,
    frequency bin ``j``) for the hover readout.

    A device-resident window would cost an eager gather + a device
    round trip per mouse-motion event if indexed directly; instead the
    surrounding :data:`_POWER_BLOCK`-frame (frames, freqs) slice of the
    hovered channel is pulled once and cached, so sweeping the cursor
    across a window re-pulls only every few hundred pixels.
    """
    buf = trace.buffer
    if not isinstance(buf, jax.Array):
        return float(np.asarray(buf[i, channel, j]))
    wb = min(_POWER_BLOCK, len(buf))
    start = min((i // wb) * wb, len(buf) - wb)
    key = (id(buf), start, channel, wb)
    hit = _power_block_cache.get(key)
    if hit is None or hit[0]() is not buf:
        try:
            block = _devwatch.pull(
                lambda: np.asarray(_power_block(buf, start, channel, wb)),
                what="power block")
        except DeviceLost:
            gi = i + trace.offset  # global frame survives the re-fold
            # a hover readout is a one-off: recompute ONLY this trace
            # (full window, so no sibling window is truncated to a
            # one-frame span) — other traces flip with their own spans
            # when their next tile render touches them
            name = getattr(getattr(trace, "_node", None), "name", None)
            if not _to_host_mode(trace,
                                 targets=[name] if name else None):
                raise
            k = min(max(gi - trace.offset, 0), len(trace.buffer) - 1)
            return float(np.asarray(trace.buffer[k, channel, j]))
        _trace.trace_event("render.pull", op="power_block",
                           bytes=block.nbytes)
        for k in [k for k, v in _power_block_cache.items()
                  if v[0]() is None]:
            _power_block_cache.pop(k, None)
        if len(_power_block_cache) > 16:
            _power_block_cache.clear()
        hit = (weakref.ref(buf), block)
        _power_block_cache[key] = hit
    return float(hit[1][i - start, j])


@functools.partial(jax.jit, static_argnames=("nf",))
def noise_level_stats(buf, nf):
    """Per-channel ``(q95 of top-frequency-sixteenth dB, max dB)`` over a
    ``(frames, channels, freqs)`` linear-power window.

    The auto-leveling inputs of `src/audian/bufferedspectrogram.py:109-126`
    as a tiny device reduction: pulling the full spectrogram window to the
    host for ``np.percentile`` moves ~200 MB for a 60 s × 8 ch window; this returns ``(channels, 2)``
    floats instead.  The percentile runs on the same dB values numpy
    would see, so the result matches the host formula exactly.
    """
    db = 10.0 * jnp.log10(jnp.maximum(buf, 1e-20))
    nchan = buf.shape[1]
    tail = db[:, :, -nf:].transpose(1, 0, 2).reshape(nchan, -1)
    q95 = jnp.percentile(tail, 95.0, axis=1)
    mx = jnp.max(db, axis=(0, 2))
    return jnp.stack([q95, mx], axis=1)


def host_noise_level_stats(buf, nf):
    """Numpy twin of :func:`noise_level_stats` for host-mode windows:
    same per-channel ``(q95 of top-frequency-sixteenth dB, max dB)``
    formula, computed once and cached sticky by the caller exactly like
    the device path (per-call host re-leveling would cost O(window) log
    passes per redraw and shift the color levels every slide)."""
    with np.errstate(all="ignore"):
        db = 10.0 * np.log10(np.maximum(buf, 1e-20))
    nchan = buf.shape[1]
    tail = db[:, :, -nf:].transpose(1, 0, 2).reshape(nchan, -1)
    q95 = np.percentile(tail, 95.0, axis=1)
    mx = db.max(axis=(0, 2))
    return np.stack([q95, mx], axis=1)


@functools.partial(jax.jit, static_argnames=("wb",))
def mean_power_db_slice(buf, start, channel, offset, width, wb):
    """Mean dB spectrum of the ``width`` frames at ``start + offset`` of
    one channel, computed over a bucketed ``wb``-frame slice with masking
    — the power side plot's data (`src/audian/spectrogramplot.py:144-164`)
    pulled as one row of floats instead of the window slice."""
    part = jax.lax.dynamic_slice_in_dim(buf, start, wb, axis=0)
    part = jax.lax.dynamic_index_in_dim(part, channel, axis=1,
                                        keepdims=False)
    k = jnp.arange(wb)
    mask = ((k >= offset) & (k < offset + width))[:, None]
    mean = (jnp.sum(jnp.where(mask, part, 0.0), axis=0)
            / jnp.maximum(width, 1))
    return 10.0 * jnp.log10(jnp.maximum(mean, 1e-20))


# one dB/colormap formula for the whole repo (ops.sweep owns it)
from ..ops.sweep import db_normalize as _db_normalize

_db_tile = jax.jit(_db_normalize)


@functools.partial(jax.jit, static_argnames=())
def _db_tile_u8(power, zmin, zmax):
    return jnp.round(255.0 * _db_normalize(power, zmin, zmax)).astype(
        jnp.uint8)


@functools.partial(jax.jit, static_argnames=("wb", "quantize", "pool"))
def _db_tile_slice_all(buf, start, zmins, zmaxs, wb, quantize, pool):
    """All channels' dB tiles in one pass: ``(frames, channels, freqs)``
    power window -> ``(wb//pool, channels, freqs)`` image stack with
    per-channel color levels.  One device launch + one host pull serves
    every channel's image item (the per-channel route costs a separate
    pull each)."""
    part = jax.lax.dynamic_slice_in_dim(buf, start, wb, axis=0)
    if pool > 1:
        part = part.reshape((wb // pool, pool) + part.shape[1:]).max(axis=1)
    db = 10.0 * jnp.log10(jnp.maximum(part, 1e-20))
    span = jnp.maximum(zmaxs - zmins, 1e-12)
    img = jnp.clip((db - zmins[None, :, None]) / span[None, :, None],
                   0.0, 1.0)
    if quantize:
        img = jnp.round(255.0 * img).astype(jnp.uint8)
    return img


@functools.partial(jax.jit, static_argnames=("width", "quantize", "pool"))
def _db_tile_slice(buf, start, channel, zmin, zmax, width, quantize, pool):
    """One channel's dB tile over a bucketed-width frame slice — crop,
    screen-resolution max-pooling (peaks survive, like the trace min/max
    tiles), and dB conversion all happen on device so only pixel-sized
    data is pulled to the host."""
    part = jax.lax.dynamic_slice_in_dim(buf, start, width, axis=0)
    part = jax.lax.dynamic_index_in_dim(part, channel, axis=1,
                                        keepdims=False)
    if pool > 1:
        part = part.reshape(width // pool, pool, part.shape[-1]).max(axis=1)
    return (_db_tile_u8 if quantize else _db_tile)(part, zmin, zmax)


def _host_db_stack(part, zmins, zmaxs, pool, quantize):
    """Numpy twin of :func:`_db_tile_slice_all` for host-mode windows:
    ``(frames, channels, freqs)`` power -> per-channel-leveled image
    stack."""
    part = np.asarray(part)
    w = (len(part) // pool) * pool
    part = part[:w]
    if pool > 1:
        part = part.reshape((w // pool, pool) + part.shape[1:]).max(axis=1)
    db = 10.0 * np.log10(np.maximum(part, 1e-20))
    span = np.maximum(zmaxs - zmins, 1e-12)
    img = np.clip((db - zmins[None, :, None]) / span[None, :, None],
                  0.0, 1.0)
    if quantize:
        img = np.round(255.0 * img).astype(np.uint8)
    return img.astype(np.float32, copy=False) if not quantize else img


def _host_db_channel(part, zmin, zmax, pool, quantize):
    """Numpy twin of :func:`_db_tile_slice` (one channel)."""
    part = np.asarray(part)
    w = (len(part) // pool) * pool
    part = part[:w]
    if pool > 1:
        part = part.reshape(w // pool, pool, part.shape[-1]).max(axis=1)
    db = 10.0 * np.log10(np.maximum(part, 1e-20))
    img = np.clip((db - zmin) / max(zmax - zmin, 1e-12), 0.0, 1.0)
    if quantize:
        return np.round(255.0 * img).astype(np.uint8)
    return img.astype(np.float32, copy=False)


class SpecTiler:
    """dB image tiles from a spectrogram trace window.

    Produces normalized (or uint8-quantized) images clipped to the current
    color levels, plus the buffer-extent rectangle the image maps onto
    (`src/audian/specitem.py:23-39` + the `spec_rect` bookkeeping of
    `src/audian/bufferedspectrogram.py:63-66`).
    """

    def __init__(self, max_pixels=1920):
        self.max_pixels = int(max_pixels)
        # one batched all-channel pull per (window, geometry, levels);
        # per-channel callers slice it (see _db_tile_slice_all)
        self._cache = {}

    def tile(self, trace, channel, zmin, zmax, quantize=False, t0=None,
             t1=None, levels=None, loss_span=None):
        """dB image tile; device loss mid-render degrades to the host
        path like :meth:`TraceTiler.tile`.  ``loss_span`` (seconds)
        bounds the host-fallback recompute for full-window tile
        requests (``t0``/``t1`` None) without cropping the tile."""
        try:
            return self._tile(trace, channel, zmin, zmax, quantize, t0,
                              t1, levels)
        except DeviceLost:
            # loss_span (browser-visible seconds) limits the host
            # recompute without changing the tile extent the way t0/t1
            # would — without it a full-window tile request triggers the
            # whole-buffer scipy recompute the span mechanism avoids
            s0, s1 = loss_span if loss_span is not None else (t0, t1)
            if _to_host_mode(trace, s0, s1):
                return self._tile(trace, channel, zmin, zmax, quantize,
                                  t0, t1, levels)
            raise

    def _tile(self, trace, channel, zmin, zmax, quantize=False, t0=None,
              t1=None, levels=None):
        buf = trace.buffer
        if len(buf) == 0:
            return np.zeros((0, 0)), (0.0, 0.0, 0.0, 0.0)
        rate = trace.rate
        i0 = 0 if t0 is None else max(int(t0 * rate) - trace.offset, 0)
        i1 = len(buf) if t1 is None else min(
            int(t1 * rate + 1) - trace.offset, len(buf))
        width = max(i1 - i0, 0)
        if width == 0:
            return np.zeros((0, buf.shape[-1])), (0.0, 0.0, 0.0, 0.0)
        # bucketed width + back-shifted start: a handful of compiled
        # programs serve every scroll/zoom (see TraceTiler.tile); frames
        # beyond the screen width max-pool on device before the pull
        wb = _pow2_at_least(width)
        pool = 1
        while wb // pool > self.max_pixels * 2:
            pool *= 2
        # clamp to the buffer, keeping the width a pool multiple
        wb = min(wb, (len(buf) // pool) * pool)
        s2 = max(min(i0, len(buf) - wb), 0)
        # snap the slice so pooled columns align to the absolute grid
        s2 = (s2 // pool) * pool
        host = not isinstance(buf, jax.Array)
        if levels is not None:
            levels = np.asarray(levels, np.float32)
            boff = trace.offset

            if host:
                def fetch(gs, wc):
                    part = np.asarray(buf[gs - boff : gs - boff
                                          + wc * pool])
                    return _host_db_stack(part, levels[:, 0],
                                          levels[:, 1], pool,
                                          bool(quantize))
            else:
                def fetch(gs, wc):
                    stack = _devwatch.pull(
                        lambda: np.asarray(_db_tile_slice_all(
                            buf, gs - boff, jnp.asarray(levels[:, 0]),
                            jnp.asarray(levels[:, 1]), wc * pool,
                            bool(quantize), pool)),
                        what="spectrogram tile")
                    _trace.trace_event("render.pull", op="db_tile_all",
                                       bytes=stack.nbytes)
                    return stack

            # delta reuse across scrolls (one column = ``pool`` frames):
            # a one-bucket scroll pulls only the newly exposed columns
            key = (("host" if host else "dev"), id(trace), pool,
                   (boff + s2) % pool, bool(quantize), levels.tobytes())
            stack = _delta_columns(
                self._cache, key, trace, buf, boff + s2, wb // pool,
                pool, 1, fetch, boff + len(buf), max_entries=8)
            img = stack[:, channel, :]
        elif host:
            part = np.asarray(buf[s2 : s2 + wb, channel])
            img = _host_db_channel(part, float(zmin), float(zmax), pool,
                                   bool(quantize))
        else:
            img = _devwatch.pull(
                lambda: np.asarray(_db_tile_slice(
                    jnp.asarray(buf), s2, channel, float(zmin),
                    float(zmax), wb, bool(quantize), pool)),
                what="spectrogram tile")
            _trace.trace_event("render.pull", op="db_tile",
                               bytes=img.nbytes)
        img = img[(i0 - s2) // pool : -(-(i1 - s2) // pool)]
        i0 = s2 + ((i0 - s2) // pool) * pool
        i1 = min(i0 + img.shape[0] * pool, s2 + wb)
        node = getattr(trace, "_node", trace)
        fmax = node.frequencies[-1] + node.fresolution if hasattr(
            node, "frequencies") else 0.0
        rect = ((trace.offset + i0) / rate, 0.0, (i1 - i0) / rate, fmax)
        return img, rect

    def power_at(self, trace, t, f, channel):
        """Per-pixel power lookup for the hover readout
        (`src/audian/specitem.py:23-30`)."""
        node = getattr(trace, "_node", trace)
        i = int(t * trace.rate)
        j = int(round(f / node.fresolution))
        if not (0 <= i < trace.frames):
            return None
        nb = trace.spec.more_shape[0]
        j = min(max(j, 0), nb - 1)
        ib = i - trace.offset
        if not 0 <= ib < len(trace.buffer):
            return float(np.asarray(trace[i, channel, j]))
        return power_value(trace, ib, channel, j)
