"""Strided-window matmul, the shared core of the batch DSP stages.

FIR filtering (a Toeplitz bank per 128-sample output block), the
symmetric-kernel envelope and the STFT (a windowed DFT matrix) are all::

    y[f] = x[:, f*S : f*S + K] @ w        f = 0 .. nframes-1

The overlapped windows are built from reshapes of shifted views of the
stream (``ceil(K/S)`` row views of width ``S``, concatenated and cropped
to ``K``), never from an index-matrix gather: a gather embeds a huge
constant in the program.  The matmul is one ``dot_general`` that XLA
hands to the GPU's GEMM library.

Layout: channels-first ``x (C, n)``.

Precision: every dot runs at ``Precision.HIGHEST``.  On a GPU a float32
dot without a precision may run in TF32 (about three decimal digits),
which breaks the 1e-5 scipy-oracle contract.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["window_matmul"]


@functools.partial(
    jax.jit,
    static_argnames=("stride", "nframes", "precision", "premap",
                     "out_layout"),
)
def window_matmul(x, w, stride, nframes, precision=lax.Precision.HIGHEST,
                  premap=None, out_layout="fco"):
    """Compute ``y[f] = premap(x)[:, f*stride : f*stride + K] @ w``.

    Parameters
    ----------
    x : (C, n) float32 (or int16 with a dequantizing ``premap``),
        channels-first.  Samples past ``n`` read as zeros.
    w : (K, O) float32 analysis matrix (Toeplitz bank or windowed DFT).
    stride : frame hop S (static).
    nframes : number of output frames (static).
    premap : optional elementwise function applied to ``x`` before the
        windows are built (e.g. rectification for the envelope); it must
        map 0 to 0, since the zero tail is padded after it.  Pass a
        module-level function: a fresh lambda is a fresh static cache
        key and recompiles every call.
    out_layout : "fco" returns (nframes, C, O); "cf" returns the
        channels-first stream (C, nframes*O) — the natural input of a
        following windowed op.

    Returns (nframes, C, O) or (C, nframes*O) float32.
    """
    C, n = x.shape
    K, O = w.shape
    S = int(stride)
    rows_per_win = -(-K // S)
    nrows = nframes + rows_per_win - 1
    need = nrows * S
    x = x[:, :need]
    if premap is not None:
        x = premap(x)
    x = x.astype(w.dtype)
    if need > n:
        x = jnp.pad(x, [(0, 0), (0, need - n)])
    rows = x.reshape(C, nrows, S)
    frames = jnp.concatenate(
        [rows[:, j : j + nframes] for j in range(rows_per_win)], axis=2
    )[:, :, :K]                                        # (C, nframes, K)
    y = lax.dot_general(
        frames, w,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )                                                  # (C, nframes, O)
    if out_layout == "fco":
        return y.transpose(1, 0, 2)
    return y.reshape(C, nframes * O)
