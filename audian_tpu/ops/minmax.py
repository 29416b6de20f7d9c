"""Min/max decimation and multi-resolution pyramids.

The reference renders traces at O(pixels) cost by decimating the visible
window to per-pixel min/max pairs with ``np.minimum/maximum.reduceat``
(`src/audian/traceitem.py:33-82`) and precomputes a whole-file min/max
overview with a pool of worker processes (`src/audian/compresseddata.py:25-53`).
Here decimation is a reshape-reduce that XLA fuses on the device, and instead
of recomputing per view we build a log-2 *pyramid* once: level ``k+1`` folds
pairs of level-``k`` extrema, so any zoom level is served by a slice of the
nearest pyramid level.

Output layout matches the reference's interleaved convention
(``out[0::2] = min``, ``out[1::2] = max`` per segment,
`src/audian/traceitem.py:55-61`, `src/audian/compresseddata.py:49-52`), so
the fulltrace cache files stay format-compatible.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "minmax_decimate",
    "interleave_minmax",
    "minmax_interleaved",
    "minmax_pyramid",
    "pyramid_levels",
]


def _segment_reduce(x, step):
    """Per-segment (min, max) along axis 0; ragged tail padded neutrally.

    Returns two arrays of shape ``(ceil(n/step),) + x.shape[1:]``.
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    nseg = -(-n // step)
    pad = nseg * step - n
    if pad:
        padw = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        xmin = jnp.pad(x, padw, constant_values=jnp.inf)
        xmax = jnp.pad(x, padw, constant_values=-jnp.inf)
    else:
        xmin = xmax = x
    shape = (nseg, step) + x.shape[1:]
    return (
        jnp.min(xmin.reshape(shape), axis=1),
        jnp.max(xmax.reshape(shape), axis=1),
    )


def minmax_decimate(x, step):
    """Segment-wise minima and maxima (segments of ``step`` samples along
    axis 0, ragged tail reduced over the remaining samples — the reduceat
    semantics of `src/audian/traceitem.py:55-61`).

    Returns ``(mins, maxs)``, each ``(ceil(n/step),) + x.shape[1:]``.
    """
    if step <= 1:
        x = jnp.asarray(x)
        return x, x
    return _segment_reduce(x, step)


def interleave_minmax(mins, maxs):
    """Interleave to the reference's plot/cache layout:
    ``out[0::2] = mins``, ``out[1::2] = maxs``."""
    mins = jnp.asarray(mins)
    stacked = jnp.stack([mins, jnp.asarray(maxs)], axis=1)
    return stacked.reshape((2 * mins.shape[0],) + mins.shape[1:])


def minmax_interleaved(x, step):
    """One-call fused decimate + interleave (the per-view hot path)."""
    return interleave_minmax(*minmax_decimate(x, step))


def pyramid_levels(n, base_step, min_len=2):
    """Number of power-of-two pyramid levels above ``base_step`` until a
    level has fewer than ``min_len`` segments."""
    levels = 0
    nseg = -(-n // base_step)
    while nseg >= min_len:
        levels += 1
        nseg = -(-nseg // 2)  # each fold keeps ceil(nseg/2) segments
    return max(levels, 1)


def minmax_pyramid(x, base_step, levels=None):
    """Build a multi-resolution min/max pyramid.

    Level 0 decimates by ``base_step``; level ``k+1`` folds adjacent pairs
    of level-``k`` extrema (exact: min of mins / max of maxs), so the whole
    pyramid costs barely more than level 0 alone.

    Returns a list of ``(mins, maxs)`` tuples, coarsest last.
    """
    x = jnp.asarray(x)
    if levels is None:
        levels = pyramid_levels(x.shape[0], base_step)
    mins, maxs = minmax_decimate(x, base_step)
    out = [(mins, maxs)]
    for _ in range(1, levels):
        if mins.shape[0] < 2:
            break
        # one stacked fold instead of two _segment_reduce calls that
        # each discard half their work (one dispatch instead of two);
        # min(-maxs) == -max(maxs)
        both = jnp.stack([mins, -maxs], axis=-1)
        folded, _ = _segment_reduce(both, 2)
        mins, maxs = folded[..., 0], -folded[..., 1]
        out.append((mins, maxs))
    return out


def reduceat_like(x, step):
    """Numpy oracle helper mirroring the reference's reduceat call pattern
    (for tests): interleaved min/max with ragged tail."""
    x = np.asarray(x)
    segments = np.arange(0, len(x), step)
    out = np.empty((2 * len(segments),) + x.shape[1:], x.dtype)
    out[0::2] = np.minimum.reduceat(x, segments, axis=0)
    out[1::2] = np.maximum.reduceat(x, segments, axis=0)
    return out
