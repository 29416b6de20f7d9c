"""Fused, decimating batch-detection envelope (envelope-only fast path).

The song-detection front half (`songdetector.py:36-69` in the reference:
zero-phase band-pass, squared-signal envelope, decimation) only ever
*consumes the decimated envelope* when run in batch mode — the filtered
full-rate stream is pulled solely for interactive plots.  The default
device path (:func:`audian_tpu.analysis.events._band_env_device`) still
materializes every full-rate intermediate (forward+backward filter
passes, the squared stream, the smoothed envelope) in device memory
before a strided gather keeps one sample in ``step``.

This module runs the same math as TWO strided-window matmuls
(:func:`audian_tpu.ops.window_matmul.window_matmul`):

1. the zero-phase band-pass as ONE symmetric-kernel convolution
   (``g_bp = h (*) reverse(h)``, :func:`audian_tpu.ops.design.
   filtfilt_sym_kernel`) over a channels-first stream (int16-ready);
2. the envelope low-pass *fused with the squaring and the decimation*:
   the square is the window build's ``premap``, and the decimation is
   folded into the analysis bank — ``B[r, o] = g_lp[o*step + L-1 - r]``
   — so each 128-output frame advances by ``128*step`` samples and only
   the decimated envelope is computed.

``sqrt(2 * e) = 2*sqrt(conv)`` happens on the tiny decimated output.

Edge semantics: interior samples match scipy's ``sosfiltfilt`` chain to
the kernel-truncation ``eps``; at chunk edges the caller supplies halos
(and odd-reflected windows at the global recording head/tail — see
``analysis/events._band_env_chunks``), so the batch output tracks the
scipy float64 oracle end to end.

The decimation ``step`` and the (pow2-bucketed) kernel lengths are baked
into the compiled program — this is the *batch* path (one compile per
config, reused across files/chunks); interactive scrubbing keeps the
step-free default path.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .design import filtfilt_sym_kernel
from .raw16 import dequant16
from .sos import _toeplitz_bank_np
from .window_matmul import window_matmul

__all__ = ["EnvDet"]


def _dequant(v):
    """int16 raw-PCM premap (k/2^15, the loader's convention), applied
    before the windows are built.  Module-level: a fresh lambda would be
    a new static cache key per call (see fused._rectify)."""
    return dequant16(v) if v.dtype == jnp.int16 else v


def _square(v):
    return v * v


def _decimating_bank(g, step, block=128):
    """Analysis bank ``B[r, o] = g[o*step + L-1 - r]``: frame ``f`` of a
    window matmul at stride ``block*step`` then yields
    ``out[f*block+o] = sum_m g[m] y[(f*block+o)*step + (L-1) - m]`` —
    ``block`` decimated convolution outputs per frame, with the smoother's
    full look-back folded into the row offset."""
    g = np.asarray(g, np.float64)
    L = len(g)
    K = (block - 1) * step + L
    r = np.arange(K)[:, None]
    o = np.arange(block)[None, :]
    idx = o * step + (L - 1) - r
    return np.where((idx >= 0) & (idx < L),
                    g[np.clip(idx, 0, L - 1)], 0.0).astype(np.float32)


@functools.partial(
    jax.jit,
    static_argnames=("step", "nout", "hb", "d_bp", "lb", "d_lp", "ll",
                     "precision"))
def _envdet_call(xw, off0, w_bp, b2, *, step, nout, hb, d_bp, lb, d_lp,
                 ll, precision):
    """One chunk: ``xw (W, C)`` window (f32 or raw int16), ``off0`` the
    TRACED in-window index of the first decimated output (the global
    decimation grid is not chunk-aligned; a static offset would bake a
    fresh program per chunk).  Returns the ``(nout, C)`` envelope."""
    x_cf = xw.T  # (C, W): channels-first for the window kernels
    C = x_cf.shape[0]
    lead2 = ll - 1 - d_lp            # stage-2 look-back in y samples
    base = hb + d_bp - lead2         # stage-1 output crop offset
    n_y = lead2 + (nout - 1) * step + d_lp + 1
    w2 = base + n_y
    if w2 > x_cf.shape[1]:
        raise ValueError(
            f"window of {x_cf.shape[1]} samples cannot cover "
            f"{w2} (halo + outputs); widen the window or lower nout")
    xs = jax.lax.dynamic_slice(
        x_cf, (jnp.zeros((), jnp.int32), (off0 - hb).astype(jnp.int32)),
        (C, w2))
    # stage 1: y_ext[i] = sum_m g_bp[m] xs[hb + i - lead2 + d_bp - m]
    xp = jnp.pad(xs, [(0, 0), (lb - 1, 0)])
    nf1 = -(-(base + n_y) // 128)
    caus = window_matmul(xp, w_bp, 128, nf1, out_layout="cf",
                         premap=_dequant, precision=precision)
    y_ext = caus[:, base : base + n_y]
    # stage 2: decimating squared-envelope conv (square fused as premap)
    nf2 = -(-nout // 128)
    raw = window_matmul(y_ext, b2, 128 * step, nf2, out_layout="fco",
                        premap=_square,
                        precision=precision)     # (nf2, C, 128)
    env = raw.transpose(1, 0, 2).reshape(C, -1)[:, :nout]
    # env = sqrt(2 * e) with e = 2*conv  ->  2*sqrt(conv)
    return (2.0 * jnp.sqrt(jnp.maximum(env, 0.0))).T  # (nout, C)


class EnvDet:
    """Precompiled fused batch envelope over fixed designs and ``step``.

    Parameters
    ----------
    fdesign, edesign : :class:`audian_tpu.ops.design.FilterDesign` for
        the band-pass and the envelope low-pass (their ``fir.length``
        budgets pin the symmetric-kernel shapes, so cutoff rebinds with
        unchanged budgets reuse the compiled program).
    step : decimation step (output sample ``j`` sits at input sample
        ``j*step`` of the first output's grid position).
    nout : decimated outputs per window (static).
    hb : in-window index headroom before the first output — the caller
        guarantees ``off0 >= hb`` and ``hb >= T_lp + T_bp - 1`` (the
        combined symmetric look-back).
    precision : matmul precision for both convolution stages.  The
        default HIGHEST keeps the envelope within ~1e-6 of the f64
        oracle; ``lax.Precision.DEFAULT`` (TF32 on a GPU) relaxes it to
        ~1e-3 relative — still far below the signal/noise separation the
        detection thresholds ride on.
    """

    def __init__(self, fdesign, edesign, step, nout, hb,
                 precision=None):
        from jax import lax

        self.precision = (lax.Precision.HIGHEST if precision is None
                          else precision)
        g_bp, self.d_bp = filtfilt_sym_kernel(
            fdesign.sos, pad_to=fdesign.fir.length)
        g_lp, self.d_lp = filtfilt_sym_kernel(
            edesign.sos, pad_to=edesign.fir.length)
        self.lb = len(g_bp)
        self.ll = len(g_lp)
        self.step = int(step)
        self.nout = int(nout)
        self.hb = int(hb)
        lead2 = self.ll - 1 - self.d_lp
        if self.hb + self.d_bp < lead2:
            raise ValueError(
                f"window headroom hb={hb} is smaller than the envelope "
                f"look-back ({lead2 - self.d_bp}); widen the halo")
        # device-resident banks, passed as traced args (values rebind
        # without retracing), built on the host in numpy
        self.w_bp = jnp.asarray(
            _toeplitz_bank_np(g_bp.astype(np.float32), 128).T)
        self.b2 = jnp.asarray(_decimating_bank(g_lp, self.step))

    def window_need(self, off0_max):
        """Samples the window must hold for the largest valid ``off0``."""
        return off0_max + self.d_bp + (self.nout - 1) * self.step \
            + self.d_lp + 1

    def __call__(self, xw, off0):
        """Envelope of one window: ``xw (W, C)`` (f32 or raw int16),
        ``off0`` the in-window sample index of the first output (traced;
        ``hb <= off0`` and ``window_need(off0) <= W``)."""
        return _envdet_call(
            xw, jnp.asarray(off0), self.w_bp, self.b2, step=self.step,
            nout=self.nout, hb=self.hb, d_bp=self.d_bp, lb=self.lb,
            d_lp=self.d_lp, ll=self.ll, precision=self.precision)
