"""Amplitude envelope kernel.

Reference behavior (`src/audian/bufferedenvelope.py:34-41`): rectify and
scale by pi/2 (the mean of ``|sin|`` is 2/pi, so a unit-amplitude tone maps
to a unit envelope), smooth with a zero-phase low/band-pass, and clamp
negatives to zero in the pure-lowpass case.  Composed entirely from the
device SOS kernels, so the whole chain (filter -> rectify -> filtfilt)
fuses into one compiled program.
"""

from __future__ import annotations

import jax.numpy as jnp

from .sos import sosfiltfilt

__all__ = ["envelope"]


def envelope(x, sos, clamp_negative=True, padlen=None, axis=0,
             block_size=1 << 17):
    """Rectified, zero-phase-smoothed amplitude envelope.

    Parameters
    ----------
    x : signal, time on ``axis``.
    sos : envelope smoothing cascade from
        :func:`audian_tpu.ops.design.design_envelope_filter`; if ``None``
        the reference returns zeros (`src/audian/bufferedenvelope.py:36-37`).
    clamp_negative : clamp the result at zero (the reference does this only
        when no envelope-highpass is set).
    """
    x = jnp.asarray(x)
    if sos is None:
        return jnp.zeros_like(x)
    rect = (jnp.pi / 2) * jnp.abs(x)
    env = sosfiltfilt(sos, rect, axis=axis, padlen=padlen,
                      block_size=block_size)
    if clamp_negative:
        env = jnp.maximum(env, 0.0)
    return env
