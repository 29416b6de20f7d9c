"""Mesh-sharded batch song-detection front half.

``audian-songdetector`` scales across devices here: the recording's time axis
is sharded over the ``seq`` mesh axis, each shard extends itself with
neighbor halos (:func:`..parallel.shard.halo_exchange` — one
``ppermute`` hop per direction) and runs the zero-phase bandpass +
squared-RMS envelope + decimation locally, so only the decimated
envelope is ever materialized globally.  This is the data-parallel
equivalent of the chunked single-device driver
(`analysis/events._band_env_chunks`) and the device replacement for
the reference's whole-file scipy pass
(`/root/reference/songdetector.py:745-767`).

Numerical contract — sharded == chunked == whole, INCLUDING the
recording edges: interior shards carry halos covering the kernels'
full influence length (truncation-tolerance equality, the same
``events.detect_halo`` budget the chunked path uses), and the
head/tail halo regions — where an interior-style shard would see zero
halos instead of scipy's odd edge extension through the nonlinear
squared stage — are recomputed on the exact float64 host oracle
(``events.detect_env_oracle``, the same function the chunked driver's
edge chunks run) and patched over.

Compile discipline: the per-shard block length is bucketed to a
quarter-pow2 ladder (at most ~25% zero padding) and compiled programs
are cached per (mesh, geometry, kernel budgets) — a batch over many
different-length files reuses a handful of shapes instead of paying a
remote XLA compile per file (the `_band_env_chunks` sliding-window
rule, CLAUDE.md "never introduce unbounded chunk-shape variety").
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import sosfiltfilt_fir
from ..ops.raw16 import dequant16
from .shard import halo_exchange

__all__ = ["sharded_band_env"]

_PROGRAMS = {}  # (mesh, L, C, halo, step, fir budgets, dtype) -> fn


def _bucket_blocks(nblocks):
    """Round a per-shard decimated-block count up the quarter-pow2
    ladder {2^k, 1.25*2^k, 1.5*2^k, 1.75*2^k}: bounded shape variety,
    <= 25% padding."""
    if nblocks <= 4:
        return int(nblocks)
    k = (int(nblocks) - 1).bit_length() - 1
    base = 1 << k
    for frac in (5, 6, 7, 8):
        cand = base * frac // 4
        if cand >= nblocks:
            return cand
    return 2 * base  # pragma: no cover - frac==8 always suffices


def _program(mesh, L, C, halo, step, fdesign, edesign, dtype):
    key = (mesh, L, C, halo, step, fdesign.fir.length, fdesign.padlen,
           edesign.fir.length, edesign.padlen, str(dtype))
    fn = _PROGRAMS.get(key)
    if fn is not None:
        return fn
    filt_pad, env_pad = fdesign.padlen, edesign.padlen

    def local(xs, params):
        ffir, fzi, efir, ezi = params
        ext = halo_exchange(xs, halo, halo, "seq")
        if ext.dtype == jnp.int16:
            ext = dequant16(ext)  # int16 moved at half the bytes
        y = sosfiltfilt_fir(ffir, ext, fzi, filt_pad, axis=0)
        e = 2.0 * sosfiltfilt_fir(efir, y * y, ezi, env_pad, axis=0)
        env = jnp.sqrt(jnp.maximum(e, 0.0)) * jnp.sqrt(2.0)
        # L % step == 0 by construction, so each shard's strided slice
        # continues the global decimation grid seamlessly
        return env[halo : halo + L : step].astype(jnp.float32)

    # jit wraps the shard_map so repeated calls (same cached closure)
    # are dispatch-cache hits; design pytrees stay traced args, so
    # coefficient rebinds within a kernel-length budget never retrace
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("seq", None), (P(), P(), P(), P())),
        out_specs=P("seq", None)))
    while len(_PROGRAMS) > 32:
        # evict the OLDEST entry (insertion order), never the whole
        # cache: each program is a 10-60 s remote XLA compile, and a
        # 33rd geometry mid-batch must not force still-hot ones to
        # recompile on the very next file
        _PROGRAMS.pop(next(iter(_PROGRAMS)))
    _PROGRAMS[key] = fn
    return fn


def sharded_band_env(mesh, fdesign, edesign, x, step):
    """Decimated squared-RMS detect envelope of ``x`` (``(n, C)``;
    int16 = raw PCM-16) over ``mesh`` (axis ``"seq"``).  Returns the
    ``(ceil(n / step), C)`` float32 envelope as a numpy array.

    Falls back to the caller's single-device path by returning None
    when the geometry does not shard usefully (recording shorter than
    a few halos per shard)."""
    from ..analysis.events import detect_env_oracle, detect_halo

    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    n, C = x.shape
    nseq = int(mesh.shape["seq"])
    halo = detect_halo(fdesign, edesign)
    L = _bucket_blocks(-(-n // (nseq * step))) * step
    n_pad = L * nseq
    if nseq < 2 or L < 2 * halo:
        return None  # not worth sharding / halo infeasible
    count = -(-n // step)

    if x.dtype != np.int16:
        x = np.asarray(x, np.float32)  # no copy when already f32
    if n_pad != n:
        x = np.pad(x, [(0, n_pad - n), (0, 0)])
    fn = _program(mesh, L, C, halo, step, fdesign, edesign, x.dtype)
    xd = jax.device_put(x, NamedSharding(mesh, P("seq", None)))
    env = np.array(fn(xd, (fdesign.fir, fdesign.zi0,
                           edesign.fir, edesign.zi0)))

    # exact head/tail patch: recompute the halo-influenced edge regions
    # through the float64 host oracle (grid-aligned slices of ONLY the
    # edges — never a whole-recording float64 copy) and overlay
    def f64(sl):
        return (sl.astype(np.float64) / 32768.0
                if sl.dtype == np.int16 else sl.astype(np.float64))

    patch = -(-halo // step)          # decimated samples to replace
    head_w = min(3 * halo, n)
    _y, head = detect_env_oracle(f64(x[:head_w]), step, fdesign,
                                 edesign)
    env[:patch] = head[:patch]
    t0 = max(((n - halo) // step) * step, 0)     # first tail grid point
    a = max(((t0 - 2 * halo) // step) * step, 0)  # aligned slice start
    _y, tail = detect_env_oracle(f64(x[a:n]), step, fdesign, edesign)
    k0 = (t0 - a) // step
    env[t0 // step : count] = tail[k0 : k0 + count - t0 // step]
    return env[:count]
