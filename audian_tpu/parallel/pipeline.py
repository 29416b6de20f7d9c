"""Sequence/channel-sharded execution of the default DSP chain.

This is the multi-chip path for whole recordings: the time axis is sharded
across the ``seq`` mesh axis, channels optionally across ``ch``; each shard
extends itself with neighbor halos (:func:`halo_exchange`) and
runs the same fused filter -> envelope / spectrogram chain the single-chip
executor runs — the device replacement for the reference's
multiprocess block-strided workers (`src/audian/compresseddata.py:25-53`)
and the scaling mechanism for hour-scale recordings (SURVEY.md section
5.7/5.8, BASELINE.json configs 2/3/5).

Numerical contract: interior frames match whole-recording execution within
the FIR truncation tolerance (same tolerance the chunked interactive path
carries).  At the global head and tail the envelope sees zero padding
where scipy's ``sosfiltfilt`` odd-reflects, so the first/last
envelope-halo (~``env.fir.length + padlen`` frames) of the *whole
recording* carries a bounded edge artifact — the same class of boundary
approximation the reference's chunk-warm-up truncation makes
(`src/audian/bufferedfilter.py:13`).  The causal filter path is exact
(zero initial conditions are scipy's own start-of-recording semantics).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import (sosfilt_fir, sosfiltfilt_sym, filtfilt_sym_kernel,
                   spectrogram, hann_window)
from ..ops.minmax import minmax_interleaved
from ..ops.raw16 import dequant16
from .shard import halo_exchange

__all__ = ["ShardedPipeline"]


from ..utils import round_up as _round_up


class ShardedPipeline:
    """Compiled sharded chain over a fixed mesh and chain configuration.

    Parameters
    ----------
    mesh : jax Mesh with axes ("seq", "ch").
    rate : sample rate (Hz).
    filt : optional :class:`audian_tpu.ops.design.FilterDesign` (bandpass).
    env : optional FilterDesign for the envelope smoother.
    env_clamp : clamp envelope at zero (pure-lowpass mode).
    nfft, hop : spectrogram geometry; ``spectrogram=False`` disables it.
    minmax_step : when set, also emit the interleaved min/max overview at
        this decimation step (the fulltrace pyramid base level).
    """

    def __init__(self, mesh, rate, filt=None, env=None, env_clamp=True,
                 nfft=256, hop=None, spectrogram=True, minmax_step=None,
                 dtype=jnp.float32):
        self.mesh = mesh
        self.rate = float(rate)
        self.filt = filt
        self.env = env
        self.env_clamp = bool(env_clamp)
        self.with_spec = bool(spectrogram)
        self.nfft = int(nfft)
        self.hop = int(hop) if hop else self.nfft // 2
        self.minmax_step = int(minmax_step) if minmax_step else None
        self.dtype = dtype
        # envelope as one symmetric conv (batch fast path; interior matches
        # scipy filtfilt to the design eps)
        if env is not None:
            g, delay = filtfilt_sym_kernel(env.sos, eps=env.fir.eps)
            # device-resident: the kernel is passed as a traced argument
            # per call (numpy would re-upload it every chunk)
            self._env_sym = (jnp.asarray(g, jnp.float32), delay)
            self._env_delay = delay
            env_halo = delay + 1
        else:
            self._env_sym = None
            self._env_delay = 0
            env_halo = 0
        hb = (filt.fir.length if filt else 0) + env_halo
        ha = max(env_halo, (self.nfft - self.hop) if self.with_spec else 0)
        # halos snap to the hop/minmax grid so output frames stay aligned
        self.align = self.hop if self.with_spec else 1
        if self.minmax_step:
            self.align = math.lcm(self.align, self.minmax_step)
        self.hb = _round_up(max(hb, 1), self.align)
        self.ha = _round_up(max(ha, 1), self.align)
        self._fn = jax.jit(self._build())

    # -- program -------------------------------------------------------------

    def _build(self):
        window = hann_window(self.nfft, jnp.float32)

        seq_size = self.mesh.shape["seq"]

        def local(x, params):
            # traced per call: filter design pytree + the envelope's
            # symmetric kernel — coefficient rebinds (same kernel-length
            # budget) take effect without a retrace.  Geometry (halos,
            # envelope delay, nfft/hop) is construction-frozen.
            filt, env_g = params
            L = x.shape[0]
            if seq_size == 1:
                # degenerate mesh: no neighbors exist and halos are zeros
                # by construction — zero-pad directly, which also lifts
                # the halo <= L restriction (short clips on one device)
                ext = jnp.pad(x, [(self.hb, self.ha)]
                              + [(0, 0)] * (x.ndim - 1))
            else:
                ext = halo_exchange(x, self.hb, self.ha, "seq")
            if ext.dtype == jnp.int16:
                # raw PCM-16 shards: the halo exchange above moved int16
                # between devices at half the f32 bytes; dequantize
                # once here, shard-locally
                ext = dequant16(ext)
                x = ext[self.hb : self.hb + L]
            y = ext
            if filt is not None:
                y = sosfilt_fir(filt.fir, y, axis=0, return_zf=False)
            out = {"filtered": y[self.hb : self.hb + L]}
            if env_g is not None:
                rect = (jnp.pi / 2) * jnp.abs(y)
                e = sosfiltfilt_sym(env_g, self._env_delay, rect, axis=0)
                if self.env_clamp:
                    e = jnp.maximum(e, 0.0)
                out["envelope"] = e[self.hb : self.hb + L]
            if self.with_spec:
                seg = y[self.hb : self.hb + L + self.nfft - self.hop]
                out["spectrogram"] = spectrogram(
                    seg, self.rate, self.nfft, self.hop, window=window
                )
            if self.minmax_step:
                # the overview decimates the *raw* trace, like the
                # reference's CompressedData (compresseddata.py:41-52);
                # shared helper so decimation semantics live in one
                # place (per-shard L is align- and hence step-aligned)
                out["minmax"] = minmax_interleaved(x, self.minmax_step)
            return out

        out_specs = {"filtered": P("seq", "ch")}
        if self.env is not None:
            out_specs["envelope"] = P("seq", "ch")
        if self.with_spec:
            out_specs["spectrogram"] = P("seq", "ch", None)
        if self.minmax_step:
            out_specs["minmax"] = P("seq", "ch")

        return jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P("seq", "ch"), (P(), P())),
            out_specs=out_specs,
        )

    # -- execution ------------------------------------------------------------

    def padded_length(self, n):
        """Global length after padding: a multiple of seq * align."""
        nseq = self.mesh.shape["seq"]
        return _round_up(n, nseq * self.align)

    def __call__(self, x):
        """Run the sharded chain over a whole recording ``(n, channels)``.

        Returns dict of global (logically unsharded) device arrays:
        ``filtered``/``envelope`` ``(n_pad, C)``, ``spectrogram``
        ``(n_pad/hop, C, nfft//2+1)``, optional ``minmax`` (real bins
        only).  The time axis stays padded to ``padded_length(n)``;
        channels are padded to the mesh internally and trimmed back.
        """
        x = jnp.asarray(x)
        if x.dtype != jnp.int16:
            # int16 stays int16 (raw PCM-16 fast path: half the transfer
            # bytes, dequantized shard-locally inside the program);
            # everything else casts to the pipeline dtype
            x = x.astype(self.dtype)
        n = x.shape[0]
        n_pad = self.padded_length(n)
        nseq = self.mesh.shape["seq"]
        L = n_pad // nseq
        if nseq > 1 and max(self.hb, self.ha) > L:
            # (with one seq shard the halos are zero padding, computed
            # locally — any clip length works)
            raise ValueError(
                f"per-shard length {L} frames is smaller than the halo "
                f"(hb={self.hb}, ha={self.ha}) — one neighbor exchange "
                f"cannot provide it; use fewer 'seq' shards, a longer "
                f"recording, or a shorter filter kernel")
        if n_pad != n:
            x = jnp.pad(x, [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1))
        # channels must divide the ch mesh axis: pad, then trim outputs
        nch = self.mesh.shape["ch"]
        C = x.shape[1]
        c_pad = _round_up(C, nch)
        if c_pad != C:
            x = jnp.pad(x, [(0, 0), (0, c_pad - C)]
                        + [(0, 0)] * (x.ndim - 2))
        sharding = NamedSharding(self.mesh, P("seq", "ch"))
        x = jax.device_put(x, sharding)
        out = self._fn(x, (self.filt,
                           self._env_sym[0] if self._env_sym else None))
        if c_pad != C:
            out = {k: (v[:, :C] if v.ndim == 2 else v[:, :C, :])
                   for k, v in out.items()}
        if self.minmax_step and n_pad != n:
            # the global zero padding lands in the overview's tail bins:
            # keep only the real bins and recompute the final (partial)
            # one from real samples, matching the interactive
            # minmax_interleaved ragged-tail semantics
            step = self.minmax_step
            nseg = -(-n // step)
            mm = out["minmax"][: 2 * nseg]
            if n % step:
                tail = x[(nseg - 1) * step : n, :C]
                if tail.dtype == jnp.int16:
                    tail = dequant16(tail)
                mm = mm.at[-2].set(jnp.min(tail, axis=0))
                mm = mm.at[-1].set(jnp.max(tail, axis=0))
            out["minmax"] = mm
        return out
