"""Playback mix-down kernels: channel averaging, heterodyne shifting,
anti-alias decimation, and fades.

Reference behavior (`src/audian/databrowser.py:1702-1742`): the selected
channels are averaged into at most two output channels (first half ->
left, second half -> right); with heterodyning enabled the mix is
multiplied by ``sin(2 pi f t)``, low-passed at 20 kHz with a zero-phase
filter and decimated to bring ultrasonic content into the audible band;
finally audioio-style 0.1 s fades are applied.

The production entry (:func:`prepare_playback`) runs HOST-SIDE end to
end on purpose: playback regions come in arbitrary lengths, and every
fresh eager device shape would be a compile of its own (see its
docstring).  The jnp helpers here are shape-stable
building blocks for device callers that manage their own geometry.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import design
from .raw16 import dequant16

__all__ = ["stereo_mixdown", "heterodyne", "fade", "prepare_playback"]

HETERODYNE_CUTOFF = 20000.0  # Hz, reference `databrowser.py:1723`


def _carrier(a, b, cycles_per_sample):
    """Host float64 carrier samples for frames [a, b) — phase reduced
    mod 1 before the sin so f32-length recordings keep full accuracy."""
    cyc = np.arange(a, b, dtype=np.float64) * cycles_per_sample
    return np.sin((2.0 * np.pi) * np.mod(cyc, 1.0))


def stereo_mixdown(x, channels=None):
    """Average channels into <=2 playback channels: first half of the shown
    channels to the left, the rest to the right
    (`src/audian/databrowser.py:1713-1717`)."""
    x = jnp.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if channels is not None:
        x = x[:, jnp.asarray(channels)]
    nch = x.shape[1]
    if nch == 1:
        return x
    n2 = (nch + 1) // 2
    left = jnp.mean(x[:, :n2], axis=1)
    right = jnp.mean(x[:, n2:], axis=1)
    return jnp.stack([left, right], axis=1)


def heterodyne(x, rate, freq):
    """Multiply with a ``sin(2 pi freq t)`` carrier to shift ultrasonic
    bands down into the audible range
    (`src/audian/databrowser.py:1718-1721`).

    Integer input (the loader's raw int16 mirror) is dequantized to
    float32 first — casting the [-1, 1] carrier to an int dtype would
    silently truncate it to zeros."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        x = dequant16(x) if x.dtype == jnp.int16 else x.astype(jnp.float32)
    # carrier phase in float64 on the host (chunked to bound RAM),
    # reduced mod 1 before the cast: a float32 time vector accumulates
    # ~1 rad of phase error at 40 kHz within a minute (and arange stops
    # being exact at 2^24).  Playback is realtime-bound, so the one
    # carrier upload per played region is immaterial.
    n = int(x.shape[0])
    c = float(freq) / float(rate)
    carrier = np.empty(n, np.float32)
    block = 1 << 22
    for a in range(0, n, block):
        b = min(a + block, n)
        carrier[a:b] = _carrier(a, b, c)
    carrier = jnp.asarray(carrier, x.dtype)
    return x * carrier.reshape((-1,) + (1,) * (x.ndim - 1))


def fade(x, rate, fade_time=0.1):
    """Sine-squared fade-in and fade-out over ``fade_time`` seconds
    (audioio ``fade`` semantics used at `src/audian/databrowser.py:1731`)."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.integer):
        # the [0, 1] ramp cannot live in an int dtype (same rule as
        # heterodyne): dequantize rather than corrupt
        x = dequant16(x) if x.dtype == jnp.int16 else x.astype(jnp.float32)
    n = x.shape[0]
    nf = min(int(round(fade_time * rate)), n // 2)
    if nf <= 0:
        return x
    ramp = jnp.sin(0.5 * jnp.pi * jnp.arange(nf, dtype=x.dtype) / nf) ** 2
    shape = (nf,) + (1,) * (x.ndim - 1)
    ramp = ramp.reshape(shape)
    x = x.at[:nf].multiply(ramp)
    x = x.at[n - nf :].multiply(ramp[::-1])
    return x


def prepare_playback(x, rate, channels=None, use_heterodyne=False,
                     heterodyne_freq=0.0, rate_fac=1.0, fade_time=0.1):
    """Full playback pipeline; returns ``(playdata, playback_rate)``.

    Runs HOST-side end to end: playback regions have arbitrary lengths,
    so device programs would compile once per region length for work
    numpy finishes in milliseconds —
    and the buffer is handed straight to the host sound device anyway.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if channels is not None:
        x = x[:, np.asarray(channels)]
    nch = x.shape[1]
    if nch <= 1:
        play = np.array(x, copy=True)
    else:
        n2 = (nch + 1) // 2
        play = np.stack([x[:, :n2].mean(axis=1), x[:, n2:].mean(axis=1)],
                        axis=1)
    out_rate = rate
    if use_heterodyne:
        n = play.shape[0]
        c = float(heterodyne_freq) / float(rate)
        block = 1 << 22
        for a in range(0, n, block):
            b = min(a + block, n)
            play[a:b] *= _carrier(a, b, c)[:, None]
        sos = design.design_filter(rate, lowpass_cutoff=HETERODYNE_CUTOFF,
                                   order=2)
        nstep = max(1, int(np.round(rate / (2 * HETERODYNE_CUTOFF))))
        if sos is not None:
            import scipy.signal as sps

            play = sps.sosfiltfilt(sos, play, axis=0)
        play = np.ascontiguousarray(play[::nstep])
        out_rate = rate / nstep
    n = play.shape[0]
    nf = min(int(round(fade_time * (out_rate / rate_fac))), n // 2)
    if nf > 0:
        ramp = np.sin(0.5 * np.pi * np.arange(nf) / nf) ** 2
        play[:nf] *= ramp[:, None]
        play[n - nf :] *= ramp[::-1][:, None]
    return play, out_rate / rate_fac
