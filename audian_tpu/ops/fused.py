"""Channels-first fused chain built on the strided-window matmul.

The throughput path for whole recordings: bandpass FIR, rectified
zero-phase envelope (symmetric kernel) and the STFT PSD, all as
strided-window matmuls (:func:`audian_tpu.ops.window_matmul.window_matmul`)
over a channels-first stream.  :meth:`FusedChainCF.chain_cf` composes the
three stages into one jitted device program; this is what ``bench.py``
measures and what the batch CLIs run per chunk.

Layout convention: ``x_cf`` is ``(channels, frames)``; the spectrogram
comes back ``(nframes, channels, nbins)`` (trace-buffer order).

Reference behavior covered (cited, not copied): the chunked
filter→envelope/spectrogram chain of `src/audian/bufferedfilter.py:31-36`,
`src/audian/bufferedenvelope.py:34-41`, `src/audian/bufferedspectrogram.py:45-66`.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from . import design
from .raw16 import dequant16
from .sos import _toeplitz_bank_np
from .stft import _dft_matrices, hann_window, one_sided_doubling
from .window_matmul import window_matmul

__all__ = ["FusedChainCF"]


def _rectify(v):
    """pi/2 rectifier passed as window_matmul's static ``premap`` — must
    be a module-level function: a fresh lambda per call would be a new
    static cache key and recompile the envelope pass every invocation."""
    return (jnp.pi / 2) * jnp.abs(v)


def _psd(y_cf, spec_w, hop, nframes, nbins):
    """PSD frames of a channels-first stream: (nframes, C, nbins)."""
    s = window_matmul(y_cf, spec_w, hop, nframes, out_layout="fco")
    re, im = s[..., :nbins], s[..., nbins:]
    return re * re + im * im


@functools.partial(
    jax.jit,
    static_argnames=("n", "block", "lead", "ha", "hop", "nbins",
                     "env_clamp", "stats", "outputs"))
def _chain_call(x_ext, filt_w, env_w, spec_w, *, n, block, lead, ha, hop,
                nbins, env_clamp, stats, outputs):
    """The chain over ``x_ext = [hb | n | ha...]``.  The filtered stream
    ``y_ext`` covers times ``[-lead, n + ha)``: ``lead`` is the
    envelope's look-back, ``ha`` the larger of its look-ahead and the
    last PSD frame's overhang past ``n``."""
    x = dequant16(x_ext) if x_ext.dtype == jnp.int16 else x_ext
    C = x.shape[0]
    m = lead + n + ha
    # hb = filter halo + lead, so frame 0 of the causal FIR over x_ext
    # lands on time -lead
    y_ext = window_matmul(x, filt_w, block, -(-m // block),
                          out_layout="cf")[:, :m]
    y = y_ext[:, lead : lead + n]
    e = psd = None
    if "envelope" in outputs:
        # bank rows start lead samples before each output: y_ext index 0
        e = window_matmul(y_ext, env_w, block, -(-n // block),
                          premap=_rectify, out_layout="cf")[:, :n]
        if env_clamp:
            e = jnp.maximum(e, 0.0)
    if "spectrogram" in outputs:
        psd = _psd(y_ext[:, lead:], spec_w, hop, n // hop, nbins)
    out = (y if "filtered" in outputs else None, e, psd)
    if not stats:
        return out
    zc = jnp.zeros((C,), jnp.float32)
    return out + ({
        "power": jnp.sum(y * y, axis=1) if out[0] is not None else zc,
        "env_sum": jnp.sum(e, axis=1) if e is not None else zc,
        "psd_sum": (jnp.sum(psd, axis=0) if psd is not None
                    else jnp.zeros((C, nbins), jnp.float32)),
    },)


class FusedChainCF:
    """Precompiled fused chain over a fixed design.

    Parameters
    ----------
    rate : sample rate (Hz).
    filt_sos / env_sos : SOS cascades (either may be None).
    nfft, hop : spectrogram geometry (``nfft`` <= a few k; the DFT runs
        as a matmul).
    eps : FIR truncation tolerance.
    block : conv output block size (the Toeplitz O dimension).
    ifir : use the two-stage interpolated-FIR envelope
        (:func:`audian_tpu.ops.design.ifir_factor`) in
        :meth:`envelope_cf`: ~2.5x fewer FLOPs for one extra pass and two
        phase transposes.  Default off; :meth:`chain_cf` always runs the
        dense envelope.

    Attributes ``hb`` and ``ha`` give the head and (minimum) tail extension
    :meth:`chain_cf` needs around each chunk; both are ``None`` without a
    filter and an envelope design.
    """

    def __init__(self, rate, filt_sos=None, env_sos=None, env_clamp=True,
                 nfft=256, hop=128, eps=1e-7, block=128, ifir=False,
                 ifir_phase=8, ifir_tol=None):
        self.rate = float(rate)
        self.nfft = int(nfft)
        self.hop = int(hop)
        self.block = int(block)
        self.env_clamp = bool(env_clamp)
        B = self.block
        if filt_sos is not None:
            h = design.impulse_response(
                filt_sos, design.effective_impulse_length(filt_sos, eps))
            self.filt_halo = len(h) - 1
            self.filt_w = jnp.asarray(
                _toeplitz_bank_np(np.asarray(h, np.float32), B).T)
        else:
            self.filt_halo = 0
            self.filt_w = None
        self.env_w = None
        self.env_mode = None
        self.env_delay = 0
        self.env_halo = 0
        self.env_lead = 0
        if env_sos is not None:
            g, delay = design.filtfilt_sym_kernel(env_sos, eps=eps)
            self.env_delay = int(delay)
            self.env_lead = len(g) - 1 - self.env_delay  # look-back
            self.env_w = jnp.asarray(
                _toeplitz_bank_np(np.asarray(g, np.float32), B).T)
            if ifir_tol is None:
                # L1 kernel error bounds the worst-case output error for
                # unit-peak input; 2e-6 keeps the full chain well inside
                # the 1e-5 scipy-oracle budget regardless of ``eps``
                ifir_tol = 2e-6
            if ifir and len(g) >= 96:
                phases = tuple(dict.fromkeys(
                    m for m in (int(ifir_phase), 8, 4) if B % m == 0))
                fit = design.ifir_factor_auto(g, ifir_tol, phases=phases)
                if fit is not None:
                    ik, gk, M, err = fit
                    lead = (len(ik) - 1) + (len(gk) - 1) * M - delay
                    if lead >= 0:
                        # two-stage interpolated FIR (design.ifir_factor):
                        # short image suppressor at full rate, model filter
                        # on the phase-major stream at stride M
                        self.env_mode = "ifir"
                        self.ifir_M = M
                        self.ifir_Lg = len(gk)
                        self.env_halo = lead
                        self.env_i_w = jnp.asarray(_toeplitz_bank_np(
                            np.asarray(ik, np.float32), B).T)
                        self.env_g_w = jnp.asarray(_toeplitz_bank_np(
                            np.asarray(gk, np.float32), B).T)
            if self.env_mode is None:
                self.env_mode = "dense"
                self.env_halo = len(g) - 1
        nbins = self.nfft // 2 + 1
        # periodic Hann + DFT matrices built host-side in float64; ONE
        # window definition shared with stft.spectrogram so the
        # fused chain's PSD cannot silently diverge from it
        win = hann_window(self.nfft, np.float64)
        W = _dft_matrices(self.nfft, nbins, np.float64)
        scale = 1.0 / (self.rate * float(np.sum(win ** 2)))
        dbl = one_sided_doubling(self.nfft)
        # fold window + sqrt(density scaling) into the analysis matrix
        amp = np.sqrt(np.concatenate([dbl * scale, dbl * scale]))
        self.spec_w = jnp.asarray((win[:, None] * W) * amp[None, :],
                                  jnp.float32)
        self.nbins = nbins
        self.hb = self.ha = None
        if self.filt_w is not None and self.env_w is not None:
            self.hb = self.filt_halo + self.env_lead
            self.ha = max(self.env_delay, self.nfft - self.hop, 0)

    # -- stages ---------------------------------------------------------------

    def filtered_cf(self, x_cf):
        """Causal bandpass of a channels-first stream; same length."""
        if self.filt_w is None:
            return x_cf
        C, n = x_cf.shape
        B = self.block
        xp = jnp.pad(x_cf, [(0, 0), (self.filt_halo, 0)])
        nf = -(-n // B)
        y = window_matmul(xp, self.filt_w, B, nf, out_layout="cf")
        return y[:, :n]

    def envelope_cf(self, y_cf):
        """Rectified symmetric-kernel envelope of a (filtered) stream.

        Rectification is the window build's ``premap``.  Interior matches
        scipy's pi/2-rectified sosfiltfilt.  In "ifir" mode the long
        smoothing kernel runs as two short matmul stages (image suppressor, then the model filter on the
        phase-major stream) — ~2.5x fewer FLOPs at the same accuracy.
        """
        if self.env_mode is None:
            return jnp.zeros_like(y_cf)
        if self.env_mode == "ifir":
            return self._envelope_ifir_cf(y_cf)
        C, n = y_cf.shape
        B = self.block
        xp = jnp.pad(y_cf, [(0, 0), (self.env_halo, self.env_delay)])
        nf = -(-(n + self.env_delay) // B)
        e = window_matmul(
            xp, self.env_w, B, nf, out_layout="cf",
            premap=_rectify,
        )
        e = e[:, self.env_delay : self.env_delay + n]
        if self.env_clamp:
            e = jnp.maximum(e, 0.0)
        return e

    def _envelope_ifir_cf(self, y_cf):
        """Two-stage IFIR envelope.

        With u = i * (pi/2)|y| computed from t = delay - (Lg-1)*M onward,
        the model-filter stage is a plain causal convolution along each
        phase row: e[t] = sum_j g[j] u[t + delay - j*M].
        """
        C, n = y_cf.shape
        B = self.block
        M = self.ifir_M
        n_pad = -(-n // M) * M
        # stage A input: the env_halo left pad already folds in the
        # stage-A halo (env_halo = Li-1 + (Lg-1)M - delay)
        xp = jnp.pad(y_cf, [(0, 0),
                            (self.env_halo, self.env_delay + n_pad - n)])
        n_u = n_pad + (self.ifir_Lg - 1) * M
        nf_a = -(-n_u // B)
        u = window_matmul(
            xp, self.env_i_w, B, nf_a, out_layout="cf",
            premap=_rectify,
        )[:, :n_u]
        # phase decomposition: one transpose into and one out of the
        # phase-major layout
        Q = n_u // M
        u_pm = u.reshape(C, Q, M).transpose(0, 2, 1).reshape(C * M, Q)
        q_out = n_pad // M
        nf_b = -(-q_out // B)
        e_pm = window_matmul(u_pm, self.env_g_w, B, nf_b,
                             out_layout="cf")[:, :q_out]
        e = e_pm.reshape(C, M, q_out).transpose(0, 2, 1).reshape(
            C, n_pad)[:, :n]
        if self.env_clamp:
            e = jnp.maximum(e, 0.0)
        return e

    def spectrogram_fc(self, y_cf, nframes=None):
        """PSD spectrogram of a channels-first stream: (nf, C, nbins)."""
        C, n = y_cf.shape
        if nframes is None:
            nframes = max((n - self.nfft) // self.hop + 1, 0)
        return _psd(y_cf, self.spec_w, self.hop, nframes, self.nbins)

    #: the full output set of :meth:`chain_cf` (and its default mask)
    ALL_OUTPUTS = ("filtered", "envelope", "spectrogram")

    def chain_cf(self, x_ext, n, stats=False, outputs=ALL_OUTPUTS):
        """Run the whole chain as one device program over an extended
        stream ``[hb | n | ha]`` (``hb = self.hb``, ``ha >= self.ha``,
        channels-first).  Returns ``(filtered, envelope, psd)`` with
        shapes (C, n), (C, n) and (n // hop, C, nbins) — the batch
        throughput path.

        ``x_ext`` may be float32 or int16; int16 is raw PCM-16
        (sample = k/2^15, the loader's raw16 convention) and is
        dequantized on the device, bit-equal to feeding the dequantized
        float32 stream.

        With ``stats=True`` a fourth element carries per-chunk
        statistics (``power`` = per-channel sum of the filtered signal
        squared, ``env_sum`` = per-channel envelope mass, ``psd_sum`` =
        per-channel PSD column sums over the chunk's frames — the inputs
        to noise-floor auto-leveling); pulling just those tiny arrays
        fences the chunk without copying the full outputs to the host.

        ``outputs`` is a static mask (a non-empty subset of
        ``ALL_OUTPUTS``): stages not requested are not computed, their
        tuple positions are ``None`` and their stats report zero."""
        outputs = tuple(outputs)
        bad = set(outputs) - set(self.ALL_OUTPUTS)
        if bad or not outputs:
            raise ValueError(
                f"outputs must be a non-empty subset of "
                f"{self.ALL_OUTPUTS}, got {outputs!r}")
        if self.hb is None:
            raise ValueError(
                "chain_cf needs filter + envelope designs; use the "
                "per-stage methods")
        return _chain_call(
            x_ext, self.filt_w, self.env_w, self.spec_w, n=int(n),
            block=self.block, lead=self.env_lead, ha=self.ha,
            hop=self.hop, nbins=self.nbins, env_clamp=self.env_clamp,
            stats=bool(stats), outputs=outputs)

    def __call__(self, x_cf, nspec_frames=None,
                 outputs=("filtered", "envelope", "spectrogram")):
        y = self.filtered_cf(x_cf)
        out = {}
        if "filtered" in outputs:
            out["filtered"] = y
        if self.env_mode is not None and "envelope" in outputs:
            out["envelope"] = self.envelope_cf(y)
        if "spectrogram" in outputs:
            out["spectrogram"] = self.spectrogram_fc(y, nspec_frames)
        return out
