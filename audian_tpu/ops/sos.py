"""Second-order-section (SOS) IIR filtering on the accelerator.

The reference filters with scipy's C implementations — causal ``sosfilt``
per channel (`src/audian/bufferedfilter.py:31-36`) and zero-phase
``sosfiltfilt`` (`src/audian/bufferedenvelope.py:34-41`).  An IIR cascade is
an inherently sequential per-sample recurrence, which maps poorly onto a
massively parallel machine if translated literally.  This module provides
two parallel execution strategies:

**Blocked associative scan** (exact; the default).  Each second-order
section in transposed direct form II is the affine state recurrence::

    s[n+1] = M s[n] + K x[n]        M = [[-a1, 1], [-a2, 0]]
    y[n]   = b0 x[n] + s1[n]        K = [b1 - a1 b0,  b2 - a2 b0]

Affine maps compose associatively, so the per-sample states are a
``jax.lax.associative_scan`` over ``(M, K x[n])`` pairs — O(log n) depth,
fully parallel across samples and channels.  To bound memory for hour-long
recordings the signal is split into blocks: ``lax.scan`` carries the 2-entry
state across blocks, the associative scan runs inside each block.
Coefficients are *traced* arguments, so interactively scrubbing a cutoff
frequency re-runs the same compiled program — it never recompiles.

**Truncated-FIR convolution** (fast path, :func:`sosfilt_fir`).  A stable
cascade's impulse response decays geometrically (rate = largest pole
magnitude), so convolving with the response truncated where it falls below
``eps`` gives the same output to within ``eps`` — but as a dense
convolution that runs as matmuls (the GPU's GEMM library).  Initial-state effects enter as a
precomputed rank-``2*nsec`` correction on the first ``T`` samples; the
final state is recovered from the last ``T`` inputs, so streaming
block-chaining is exact up to the same ``eps``.

``zi`` conventions and ``sosfiltfilt`` padding/initial conditions follow
scipy exactly so outputs are oracle-comparable at 1e-5 or better.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import design

__all__ = [
    "sosfilt",
    "sosfilt_fir",
    "sosfiltfilt",
    "sosfilt_zi",
    "odd_ext",
]


def _combine_affine(e1, e2):
    """Compose two affine maps ``s -> A s + v`` (e2 after e1)."""
    a11, a12, a21, a22, v1a, v2a = e1
    b11, b12, b21, b22, v1b, v2b = e2
    return (
        b11 * a11 + b12 * a21,
        b11 * a12 + b12 * a22,
        b21 * a11 + b22 * a21,
        b21 * a12 + b22 * a22,
        b11 * v1a + b12 * v2a + v1b,
        b21 * v1a + b22 * v2a + v2b,
    )


def _section_scan(x, coeffs, zi):
    """Run one second-order section over ``x`` (time on axis 0).

    Parameters
    ----------
    x : (n, ...) input.
    coeffs : length-6 of scalars ``(b0, b1, b2, a0=1, a1, a2)``.
    zi : (2,) + x.shape[1:] initial state (transposed DF2 convention, same
        as scipy's per-section ``zi``).

    Returns ``(y, zf)``.
    """
    b0, b1, b2, _, a1, a2 = coeffs
    k1 = b1 - a1 * b0
    k2 = b2 - a2 * b0
    ones = jnp.ones_like(x)
    zeros = jnp.zeros_like(x)
    elems = (-a1 * ones, ones, -a2 * ones, zeros, k1 * x, k2 * x)
    c11, c12, c21, c22, w1, w2 = lax.associative_scan(_combine_affine, elems, axis=0)
    # State *after* sample n:
    s1 = c11 * zi[0] + c12 * zi[1] + w1
    s2 = c21 * zi[0] + c22 * zi[1] + w2
    # y[n] needs the state *before* sample n:
    z1_before = jnp.concatenate([zi[0][None], s1[:-1]], axis=0)
    y = b0 * x + z1_before
    zf = jnp.stack([s1[-1], s2[-1]])
    return y, zf


def _section_blocked(x, coeffs, zi, block_size):
    """Blocked version of :func:`_section_scan`: ``lax.scan`` over blocks of
    ``block_size`` samples carrying the 2-entry state, associative scan
    inside each block.  Bounds peak memory to O(block_size).

    The remainder (partial trailing block) is processed separately rather
    than zero-padded so the returned final state is exact."""
    n = x.shape[0]
    if n <= block_size:
        return _section_scan(x, coeffs, zi)
    nfull = n // block_size
    rem = n - nfull * block_size
    xb = x[: nfull * block_size].reshape((nfull, block_size) + x.shape[1:])

    def step(carry, xblk):
        y, zf = _section_scan(xblk, coeffs, carry)
        return zf, y

    zf, yb = lax.scan(step, zi, xb)
    y = yb.reshape((nfull * block_size,) + x.shape[1:])
    if rem:
        ytail, zf = _section_scan(x[nfull * block_size :], coeffs, zf)
        y = jnp.concatenate([y, ytail], axis=0)
    return y, zf


def _normalize_sos(sos, dtype):
    sos = jnp.asarray(sos, dtype=dtype)
    if sos.ndim == 1:
        sos = sos[None, :]
    return sos


def sosfilt(sos, x, zi=None, axis=0, block_size=1 << 17, return_zf=None):
    """Causal SOS filtering, scipy-``sosfilt``-compatible, on device.

    Parameters
    ----------
    sos : (nsec, 6) array-like — may be a traced jnp array so interactive
        coefficient changes never trigger recompilation.
    x : input signal.
    zi : optional initial conditions, scipy shape convention
        ``(nsec, ..., 2, ...)`` with 2 replacing the time axis.
    axis : time axis of ``x``.
    block_size : samples per associative-scan block (memory bound).
    return_zf : if True (default: ``zi is not None``) also return final
        conditions.

    Oracle: `scipy.signal.sosfilt` (used by the reference at
    `src/audian/bufferedfilter.py:31-36`).
    """
    if return_zf is None:
        return_zf = zi is not None
    x = jnp.asarray(x)
    # normalize: the zi/zf moveaxis below uses `1 + axis`, which is only
    # correct for non-negative axes
    axis = axis % max(x.ndim, 1)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    sos = _normalize_sos(sos, dtype)
    nsec = sos.shape[0]
    xt = jnp.moveaxis(x, axis, 0)
    if zi is None:
        zi_t = jnp.zeros((nsec, 2) + xt.shape[1:], dtype=dtype)
    else:
        zi_t = jnp.moveaxis(jnp.asarray(zi, dtype=dtype), 1 + axis, 1)
    y = xt
    zfs = []
    for s in range(nsec):
        coeffs = tuple(sos[s, i] for i in range(6))
        y, zf = _section_blocked(y, coeffs, zi_t[s], block_size)
        zfs.append(zf)
    out = jnp.moveaxis(y, 0, axis)
    if return_zf:
        zf = jnp.moveaxis(jnp.stack(zfs), 1, 1 + axis)
        return out, zf
    return out


def sosfilt_zi(sos):
    """Steady-state step-response initial conditions (scipy
    ``sosfilt_zi``), computed in-graph so traced coefficients work.

    Returns shape ``(nsec, 2)``.
    """
    sos = _normalize_sos(sos, jnp.result_type(jnp.asarray(sos).dtype, jnp.float32))
    b0, b1, b2 = sos[:, 0], sos[:, 1], sos[:, 2]
    a1, a2 = sos[:, 4], sos[:, 5]
    k1 = b1 - a1 * b0
    k2 = b2 - a2 * b0
    # zi solves (I - M) zi = K with M = [[-a1, 1], [-a2, 0]]:
    det = 1.0 + a1 + a2
    zi1 = (k1 + k2) / det
    zi2 = ((1.0 + a1) * k2 - a2 * k1) / det
    zi = jnp.stack([zi1, zi2], axis=1)
    # Chain sections through the cascade's cumulative DC gain:
    dc = (b0 + b1 + b2) / det
    scale = jnp.concatenate([jnp.ones((1,), sos.dtype), jnp.cumprod(dc)[:-1]])
    return zi * scale[:, None]


def odd_ext(x, n, axis=0):
    """Odd extension at both ends along ``axis`` (scipy ``odd_ext``)."""
    if n == 0:
        return jnp.asarray(x)
    x = jnp.asarray(x)
    xt = jnp.moveaxis(x, axis, 0)
    if n > xt.shape[0] - 1:
        # scipy raises here too; jnp slice clipping would otherwise
        # return a silently short, wrong-valued extension
        raise ValueError(
            f"extension length n ({n}) is too big; it must not exceed "
            f"x.shape[axis]-1 ({xt.shape[0] - 1})")
    left = 2 * xt[0] - xt[n:0:-1]
    right = 2 * xt[-1] - xt[-2 : -(n + 2) : -1]
    out = jnp.concatenate([left, xt, right], axis=0)
    return jnp.moveaxis(out, 0, axis)


def sosfiltfilt(sos, x, axis=0, padlen=None, block_size=1 << 17):
    """Zero-phase forward-backward SOS filtering, scipy-``sosfiltfilt``
    semantics (odd edge padding, steady-state initial conditions scaled by
    the edge samples).

    Oracle: `scipy.signal.sosfiltfilt` (used by the reference's envelope at
    `src/audian/bufferedenvelope.py:34-41` and playback lowpass at
    `src/audian/databrowser.py:1725-1730`).

    ``padlen`` must be static; the default matches scipy's.
    """
    x = jnp.asarray(x)
    if padlen is None:
        try:
            padlen = design.filtfilt_padlen(np.asarray(sos))
        except Exception as e:  # traced sos inside jit
            raise ValueError(
                "sosfiltfilt: pass a static padlen= when sos is traced"
            ) from e
    if x.shape[axis] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen, "
            f"which is {padlen}."
        )
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    sosj = _normalize_sos(sos, dtype)
    nsec = sosj.shape[0]
    xt = jnp.moveaxis(x, axis, 0)
    ext = odd_ext(xt, padlen, axis=0)
    zi0 = sosfilt_zi(sosj).astype(dtype)  # (nsec, 2)
    bshape = (nsec, 2) + (1,) * (xt.ndim - 1)

    def _zi_for(edge):
        return zi0.reshape(bshape) * edge[None, None]

    y = sosfilt(sosj, ext, zi=_zi_for(ext[0]), axis=0,
                block_size=block_size, return_zf=False)
    y = y[::-1]
    y = sosfilt(sosj, y, zi=_zi_for(y[0]), axis=0,
                block_size=block_size, return_zf=False)
    y = y[::-1]
    if padlen:
        y = y[padlen:-padlen]
    return jnp.moveaxis(y, 0, axis)


# ---------------------------------------------------------------------------
# Fast path: truncated impulse response as block matmuls.
# ---------------------------------------------------------------------------


def _toeplitz_bank(h, block):
    """Build the (block, block+T-1) Toeplitz matrix H with
    ``H[o, k] = h[o + T - 1 - k]`` (zero outside [0, T)).

    Built by gathering from a zero-padded ``h`` with a static index matrix,
    so ``h`` may be a traced argument: scrubbing a filter cutoff reuses the
    compiled program as long as the (bucketed) kernel length is unchanged.
    """
    T = h.shape[0]
    hp = jnp.concatenate([h, jnp.zeros((1,), h.dtype)])
    o = np.arange(block)[:, None]
    k = np.arange(block + T - 1)[None, :]
    idx = o + (T - 1) - k
    idx = np.where((idx >= 0) & (idx < T), idx, T)  # T -> the zero slot
    return hp[idx]


def _toeplitz_bank_np(h, block):
    """Host-side (numpy) twin of :func:`_toeplitz_bank` for concrete
    kernels: the eager index-matrix gather would compile a device
    program per kernel length, so design-time bank construction never
    touches the device."""
    h = np.asarray(h)
    T = h.shape[0]
    o = np.arange(block)[:, None]
    k = np.arange(block + T - 1)[None, :]
    idx = o + (T - 1) - k
    return np.where((idx >= 0) & (idx < T),
                    h[np.clip(idx, 0, T - 1)], h.dtype.type(0))


def _pick_block(T):
    """Toeplitz block size: small kernels want small blocks (less zero
    padding in the bank), long kernels amortize.  On an H100 (400 W power
    limit), at the interactive window (60 s x 8 ch x 96 kHz) with the
    175-tap 2-40 kHz band-pass, blocks of 128 / 256 / 512 took 1.38 /
    1.51 / 1.92 ms per call; the 512 block for kernels over 384 taps is
    not measured on that card."""
    return 128 if T <= 384 else 512


def _conv1d_same_causal(x, h, block=None, precision=lax.Precision.HIGHEST):
    """Causal convolution ``y[n] = sum_j h[j] x[n-j]`` along axis 0 of a
    (n, channels) array, as overlap-save block *matmuls*.

    Precision: HIGHEST (full float32, the default) honors the 1e-5
    scipy-oracle budget with margin; on a GPU a float32 dot without a
    precision may run in TF32 (about three decimal digits).
    """
    n, c = x.shape
    T = h.shape[0]
    if block is None:
        block = _pick_block(T)
    H = _toeplitz_bank(h, block)                    # (B, B+T-1)
    nblocks = -(-n // block)
    halo = T - 1
    # frame b covers x[b*B - halo : b*B + B] (original indexing); build the
    # overlapped frames from block-aligned reshapes + shifted views instead
    # of an index-matrix gather (gathers embed huge constants -> slow
    # compiles and slow execution)
    width = block + halo
    k = -(-width // block)
    nrows = nblocks + k - 1
    xp = jnp.pad(x, [(halo, nrows * block - halo - n), (0, 0)])
    rows = xp.reshape(nrows, block, c)
    frames = jnp.concatenate(
        [rows[j : j + nblocks] for j in range(k)], axis=1
    )[:, :width]                                     # (nb, B+T-1, C)
    y = jnp.einsum(
        "ok,bkc->boc", H, frames,
        precision=precision,
        preferred_element_type=x.dtype,
    )
    return y.reshape(nblocks * block, c)[:n]


def sosfiltfilt_sym(g, delay, x, axis=0, precision=lax.Precision.HIGHEST):
    """Zero-phase filtering as ONE symmetric convolution.

    ``g, delay`` come from
    :func:`audian_tpu.ops.design.filtfilt_sym_kernel`.  Matches
    ``sosfiltfilt`` on interior samples (to the design's truncation
    ``eps``); within ``delay`` frames of the array ends the edges follow
    zero-padding rather than scipy's odd reflection, so callers must carry
    halos — this is the batch/sharded fast path, not the scipy-exact API.
    """
    x = jnp.asarray(x)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    g = jnp.asarray(g, dtype)
    xt = jnp.moveaxis(x, axis, 0)
    squeeze = xt.ndim == 1
    if squeeze:
        xt = xt[:, None]
    flat = xt.reshape(xt.shape[0], -1)
    n = flat.shape[0]
    ext = jnp.pad(flat, [(0, delay), (0, 0)])
    y = _conv1d_same_causal(ext, g, precision=precision)[delay:]
    out = y.reshape(xt.shape)
    if squeeze:
        out = out[:, 0]
    return jnp.moveaxis(out, 0, axis)


def sosfilt_fir(kernels, x, zi=None, axis=0, return_zf=None,
                precision=lax.Precision.HIGHEST):
    """Causal SOS filtering via truncated impulse response (matmul fast
    path).

    ``kernels`` is a :class:`audian_tpu.ops.design.FirKernels` precomputed
    at design time.  Output matches :func:`sosfilt` within
    ``kernels.eps`` (relative); final conditions are recovered from the
    last ``T`` samples so block-streaming stays consistent.

    ``zi`` uses the scipy per-section convention and is internally flattened
    to the cascade state vector (sections stacked, state-major).
    """
    if return_zf is None:
        return_zf = zi is not None
    x = jnp.asarray(x)
    # normalize: the zi/zf moveaxis below uses `1 + axis`, which is only
    # correct for non-negative axes
    axis = axis % max(x.ndim, 1)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    xt = jnp.moveaxis(x, axis, 0)
    squeeze = xt.ndim == 1
    if squeeze:
        xt = xt[:, None]
    flat = xt.reshape(xt.shape[0], -1)
    n = flat.shape[0]
    h = jnp.asarray(kernels.h, dtype=dtype)
    y = _conv1d_same_causal(flat, h, precision=precision)
    nstate = kernels.state_out.shape[1]
    if zi is not None:
        zi_t = jnp.moveaxis(jnp.asarray(zi, dtype=dtype), 1 + axis, 1)
        s0 = zi_t.reshape(nstate, -1)                      # (2*nsec, C)
        G = jnp.asarray(kernels.state_out[: min(n, kernels.length)], dtype=dtype)
        # precision matters on every matmul: a reduced-precision pass
        # put ~3e-3 relative error into the zi transient — i.e. into the
        # first kernels.length samples of each filtfilt pass, which are
        # exactly the scipy-exact edge samples (the CPU mesh cannot see
        # it; tests/test_device_gpu.py::test_batch_detect_envelope_on_device
        # pins it on the card)
        y = y.at[: G.shape[0]].add(jnp.matmul(G, s0, precision=precision))
    out = y.reshape(xt.shape)
    if squeeze:
        out = out[:, 0]
    out = jnp.moveaxis(out, 0, axis)
    if not return_zf:
        return out
    # Final state from the trailing T inputs (older input effects and the
    # initial state have decayed below eps by construction).
    T = min(kernels.length, n)
    Phi = jnp.asarray(kernels.input_state[:T][::-1], dtype=dtype)  # (T, 2nsec)
    zf_flat = jnp.matmul(Phi.T, flat[n - T :],
                         precision=precision)                       # (2nsec, C)
    if zi is not None and n < kernels.length and kernels.A is not None:
        # the initial state has NOT decayed within this short block:
        # carry A**n @ s0 (binary exponentiation at trace time; n static)
        An = jnp.eye(nstate, dtype=dtype)
        P = jnp.asarray(kernels.A, dtype)
        k = n
        while k:
            if k & 1:
                An = jnp.matmul(An, P, precision=precision)
            P = jnp.matmul(P, P, precision=precision)
            k >>= 1
        zf_flat = zf_flat + jnp.matmul(An, s0, precision=precision)
    zf = zf_flat.reshape((nstate // 2, 2) + xt.shape[1:])
    if squeeze:
        zf = zf[..., 0]
    else:
        zf = jnp.moveaxis(zf, 1, 1 + axis)
    return out, zf


def sosfiltfilt_fir(kernels, x, zi0, padlen, axis=0):
    """Zero-phase filtering on the FIR fast path (scipy-``sosfiltfilt``
    semantics: odd edge padding, steady-state initial conditions scaled by
    the edge samples).

    This is the production path for the envelope node: in float32 the
    forward-backward scan loses precision for low cutoffs while the FIR
    formulation stays at ~1e-7 (see test_sos.py).

    Parameters
    ----------
    kernels : :class:`audian_tpu.ops.design.FirKernels` (traced-friendly).
    zi0 : (nsec, 2) steady-state IC coefficients (``sosfilt_zi``), also
        traced-friendly.
    padlen : static edge padding length
        (:func:`audian_tpu.ops.design.filtfilt_padlen`).
    """
    x = jnp.asarray(x)
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    x = x.astype(dtype)
    xt = jnp.moveaxis(x, axis, 0)
    if xt.shape[0] <= padlen:
        raise ValueError(
            f"The length of the input vector x must be greater than padlen, "
            f"which is {padlen}."
        )
    ext = odd_ext(xt, padlen, axis=0)
    zi0 = jnp.asarray(zi0, dtype)
    bshape = zi0.shape + (1,) * (xt.ndim - 1)

    def _zi_for(edge):
        return zi0.reshape(bshape) * edge[None, None]

    y = sosfilt_fir(kernels, ext, zi=_zi_for(ext[0]), axis=0, return_zf=False)
    y = y[::-1]
    y = sosfilt_fir(kernels, y, zi=_zi_for(y[0]), axis=0, return_zf=False)
    y = y[::-1]
    if padlen:
        y = y[padlen:-padlen]
    return jnp.moveaxis(y, 0, axis)
