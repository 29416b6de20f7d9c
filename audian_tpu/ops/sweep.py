"""Batched multi-resolution spectrogram sweeps.

The reference recomputes the spectrogram on the GUI thread every time the
user steps NFFT (`src/audian/databrowser.py:1188-1222` ->
`bufferedspectrogram.update`).  Here the whole interactive NFFT/overlap
sweep (BASELINE.json config 4) is ONE jitted program: every resolution is
computed in a single device launch (the DFT matmuls for all NFFTs
fuse into one schedule), and dB tiles for the GUI come back quantized.
Stepping through resolutions then costs one cached re-run, not a
recompute-and-recompile cascade.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .stft import spectrogram

__all__ = ["spectrogram_sweep", "db_quantize", "SWEEP_NFFTS",
           "FULL_NFFTS"]

#: the reference UI exposes NFFT 2^3..2^19 (`databrowser.py:516`); the
#: interactive sweep covers the practically-used band
SWEEP_NFFTS = (128, 256, 512, 1024, 2048, 4096)

#: the reference's complete UI ladder (`databrowser.py:516`): the
#: background warm visits all of it — core band first — so no
#: resolution keypress anywhere in the UI range compiles inline
FULL_NFFTS = tuple(2 ** k for k in range(3, 20))


@functools.partial(jax.jit, static_argnames=("rate", "nffts", "overlap_frac"))
def _sweep(x, rate, nffts, overlap_frac):
    out = {}
    for nfft in nffts:
        hop = max(int(round((1 - overlap_frac) * nfft)), 1)
        out[nfft] = spectrogram(x, rate, nfft, hop)
    return out


def spectrogram_sweep(x, rate, nffts=SWEEP_NFFTS, overlap_frac=0.5):
    """All requested resolutions of ``x`` in one fused device program.

    Returns ``{nfft: Sxx}`` with each ``Sxx`` shaped
    ``(nframes(nfft), ..., nfft//2+1)``.
    """
    return _sweep(jnp.asarray(x), float(rate), tuple(int(n) for n in nffts),
                  float(overlap_frac))


def db_normalize(power, zmin, zmax):
    """Power -> dB normalized to [0, 1] over [zmin, zmax] — THE dB/
    colormap normalization formula (one copy; the GUI tilers wrap it, so
    sweep tiles and view tiles cannot quantize differently)."""
    db = 10.0 * jnp.log10(jnp.maximum(power, 1e-20))
    # span floor: degenerate zmin == zmax would put NaNs in the tile
    return jnp.clip((db - zmin) / jnp.maximum(zmax - zmin, 1e-12), 0.0, 1.0)


@jax.jit
def db_quantize(power, zmin, zmax):
    """Power -> uint8 dB tile clipped to [zmin, zmax] — the colormap/dB
    quantization stage of the GUI tile path (BASELINE.json config 4)."""
    return jnp.round(255.0 * db_normalize(power, zmin, zmax)).astype(
        jnp.uint8)
