"""STFT power spectrogram and dB conversion on the device.

The reference computes spectrograms with thunderlab's mlab-style
``spectrogram`` on the host (`src/audian/bufferedspectrogram.py:45-66`) and
converts to dB with thunderlab's ``decibel`` (`src/audian/specitem.py:33-39`).
Here both are pure JAX: frames are gathered with a static index matrix,
windowed, transformed with XLA's batched real FFT, and scaled as a one-sided
power spectral density — all of which XLA fuses for the device.  Batched
over channels; ``jax.vmap`` over NFFT-sweep configurations gives the
multi-resolution interactive path.

Semantics: density-scaled PSD with a periodic Hann window and no
detrending, i.e. ``scipy.signal.spectrogram(x, fs, window='hann',
nperseg=nfft, noverlap=nfft-hop, detrend=False, scaling='density',
mode='psd')``; frame count is ``(n - nfft)//hop + 1`` which matches the
reference's buffer sizing ``nsource = (ndest-1)*hop + nfft``
(`src/audian/bufferedspectrogram.py:46-48`).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "hann_window",
    "frame_signal",
    "spectrogram",
    "spectrogram_frequencies",
    "num_frames",
    "decibel",
    "inverse_decibel",
]


def one_sided_doubling(nfft):
    """One-sided PSD doubling vector: 2 everywhere except DC (and
    Nyquist when ``nfft`` is even) — the normalization rule shared by
    :func:`spectrogram` and the fused chain (one copy, so the PSDs
    cannot silently diverge)."""
    nbins = nfft // 2 + 1
    dbl = np.full(nbins, 2.0, np.float64)
    dbl[0] = 1.0
    if nfft % 2 == 0:
        dbl[-1] = 1.0
    return dbl


@functools.lru_cache(maxsize=64)
def hann_window(nfft, dtype=jnp.float32):
    """Periodic Hann window (scipy ``get_window('hann', nfft)``).

    Returns a CACHED host numpy array (float64 math, requested dtype):
    eager device arange/cos here would dispatch per call on hot paths
    (SpectrogramNode.params runs every chunk execution), and each eager
    op would be a device compile of its own.
    Numpy (not a device array) so a call made inside a jit trace cannot
    leak a tracer into the cache; the stable object identity also lets
    GraphExecutor's device-params cache upload it exactly once."""
    n = np.arange(nfft, dtype=np.float64)
    return np.asarray(0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft),
                      np.dtype(dtype))


def num_frames(n, nfft, hop):
    """Number of full STFT frames in ``n`` samples."""
    if n < nfft:
        return 0
    return (n - nfft) // hop + 1


def spectrogram_frequencies(rate, nfft):
    """One-sided frequency axis, ``nfft//2 + 1`` bins up to Nyquist
    (reference parity: `src/audian/bufferedspectrogram.py:36-38`)."""
    return np.arange(nfft // 2 + 1) * (rate / nfft)


def frame_signal(x, nfft, hop, nframes=None):
    """Slice ``x`` (time on axis 0) into overlapping frames.

    Built from reshapes and shifted views, not a gather: an index-matrix
    gather embeds an O(nframes*nfft) constant into the program (long XLA
    compiles and slow execution for minute-long chunks).

    Returns shape ``(nframes, nfft) + x.shape[1:]``.
    """
    n = x.shape[0]
    if nframes is None:
        nframes = num_frames(n, nfft, hop)
    if nframes <= 0:
        return jnp.zeros((0, nfft) + x.shape[1:], x.dtype)
    k = -(-nfft // hop)  # hop-rows per frame
    nrows = nframes + k - 1
    need = nrows * hop
    if need > n:
        x = jnp.pad(x, [(0, need - n)] + [(0, 0)] * (x.ndim - 1))
    rows = x[:need].reshape((nrows, hop) + x.shape[1:])
    parts = [rows[j : j + nframes] for j in range(k)]
    frames = jnp.concatenate(parts, axis=1)  # (nframes, k*hop, ...)
    if k * hop != nfft:
        frames = frames[:, :nfft]
    return frames


def _dft_matrices(nfft, nbins, dtype):
    """Real/imag DFT analysis matrix, (nfft, 2*nbins) — numpy (host), so
    design-time callers never pay an eager device round trip."""
    k = np.arange(nfft)[:, None]
    b = np.arange(nbins)[None, :]
    ang = 2.0 * np.pi * k * b / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(dtype)


def spectrogram(x, rate, nfft, hop, window=None, detrend=False,
                method="auto"):
    """One-sided PSD spectrogram.

    Parameters
    ----------
    x : (n,) or (n, channels) signal, time on axis 0.
    rate : sample rate in Hz (static python float).
    nfft, hop : frame length and hop in samples (static).
    window : optional (nfft,) window; periodic Hann by default.
    detrend : False or 'constant' (subtract per-frame mean).
    method : "fft" (XLA rfft), "matmul" (real DFT as a matmul), or
        "auto" (matmul for nfft <= 1024; which one is faster on a GPU is
        not measured yet).

    Returns
    -------
    Sxx : (nframes, ..., nfft//2 + 1) power spectral density in
        ``unit**2/Hz`` — time first, frequency last, matching the derived
        trace buffer layout ``(frames, channels, freqs)``.
    """
    x = jnp.asarray(x)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    if window is None:
        window = hann_window(nfft, dtype)
    else:
        window = jnp.asarray(window, dtype)
    frames = frame_signal(x, nfft, hop)              # (nf, nfft, ...)
    if detrend == "constant":
        frames = frames - jnp.mean(frames, axis=1, keepdims=True)
    wshape = (1, nfft) + (1,) * (frames.ndim - 2)
    frames = frames * window.reshape(wshape)
    nbins = nfft // 2 + 1
    if method == "auto":
        method = "matmul" if nfft <= 1024 else "fft"
    if method == "matmul":
        W = jnp.asarray(_dft_matrices(nfft, nbins, dtype))
        # flatten channels into the matmul M dimension
        ft = jnp.moveaxis(frames, 1, -1)             # (nf, ..., nfft)
        flat = ft.reshape(-1, nfft)
        spec = jax.lax.dot(flat, W,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=dtype)
        re, im = spec[:, :nbins], spec[:, nbins:]
        psd = (re * re + im * im).reshape(ft.shape[:-1] + (nbins,))
        psd = jnp.moveaxis(psd, -1, 1)               # (nf, nbins, ...)
    else:
        spec = jnp.fft.rfft(frames, n=nfft, axis=1)  # (nf, nbins, ...)
        psd = (spec.real * spec.real + spec.imag * spec.imag).astype(dtype)
    # density scaling; window may be traced, so keep this in-graph
    scale = 1.0 / (rate * jnp.sum(window * window))
    nbins = nfft // 2 + 1
    dbl = one_sided_doubling(nfft)
    factors = (jnp.asarray(dbl, dtype) * scale.astype(dtype)).reshape(
        wshape[:1] + (nbins,) + wshape[2:]
    )
    psd = psd * factors
    # time first, frequency last:
    return jnp.moveaxis(psd, 1, -1)


def decibel(power, ref_power=1.0, min_power=1e-20):
    """Convert power to dB: ``10*log10(power/ref)``; values at or below
    ``min_power`` map to ``-inf`` (thunderlab ``decibel`` semantics, used by
    the reference at `src/audian/specitem.py:33-39` and
    `src/audian/bufferedspectrogram.py:109-126`)."""
    power = jnp.asarray(power)
    if ref_power is None:
        ref_power = jnp.max(power)
    safe = jnp.where(power <= min_power, 1.0, power / ref_power)
    return jnp.where(power <= min_power, -jnp.inf, 10.0 * jnp.log10(safe))


def inverse_decibel(db, ref_power=1.0):
    """Inverse of :func:`decibel` for finite values."""
    return ref_power * jnp.power(10.0, jnp.asarray(db) / 10.0)
