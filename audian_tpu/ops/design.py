"""Host-side IIR filter design.

Filter *design* is tiny, data-independent work that belongs on the host
(numpy/scipy); only the *data path* runs on the device.  This module
wraps Butterworth design and precomputes everything the device kernels in
:mod:`audian_tpu.ops.sos` need:

- the second-order-section (SOS) cascade coefficients,
- steady-state initial conditions (``sosfilt_zi`` semantics),
- the cascade's state-space form and truncated impulse/state responses used
  by the fast FIR (matmul convolution) execution strategy.

Behavioral contract mirrored from the reference (cited for parity checks,
not copied): the highpass/lowpass/bandpass/passthrough selection logic of
`src/audian/bufferedfilter.py:39-53` and the envelope filter design of
`src/audian/bufferedenvelope.py:44-55`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
from scipy.signal import butter, sosfilt_zi


def design_filter(rate, highpass_cutoff=0.0, lowpass_cutoff=None, order=2):
    """Design the trace filter the way the reference's filter node does.

    Returns ``None`` when the cutoffs make the filter a pass-through
    (highpass below 0.1% of Nyquist and lowpass at/above Nyquist), a
    lowpass, highpass, or bandpass Butterworth SOS cascade otherwise
    (reference parity: `src/audian/bufferedfilter.py:39-53`).
    """
    nyq = rate / 2
    if lowpass_cutoff is None:
        lowpass_cutoff = nyq
    # clamp out-of-range requests instead of raising: the interactive
    # verbs scrub cutoffs freely and must never crash the redesign
    # (the reference's GUI spin boxes clamp; headless callers have no box)
    highpass_cutoff = min(max(float(highpass_cutoff), 0.0), 0.999 * nyq)
    lowpass_cutoff = min(max(float(lowpass_cutoff), 0.0), nyq)
    if lowpass_cutoff <= highpass_cutoff:
        lowpass_cutoff = nyq  # inverted band: drop the lowpass side
    if highpass_cutoff < 0.001 * nyq and lowpass_cutoff >= nyq - 1e-8:
        return None
    if highpass_cutoff < 0.001 * nyq:
        return butter(order, lowpass_cutoff, "lowpass", fs=rate, output="sos")
    if lowpass_cutoff >= nyq - 1e-8:
        return butter(order, highpass_cutoff, "highpass", fs=rate, output="sos")
    return butter(
        order, (highpass_cutoff, lowpass_cutoff), "bandpass", fs=rate, output="sos"
    )


def design_envelope_filter(rate, envelope_cutoff=500.0, highpass_cutoff=0.0, order=2):
    """Envelope smoothing filter; ``None`` when the design is infeasible
    (reference parity: `src/audian/bufferedenvelope.py:44-55`).

    Cutoffs clamp like :func:`design_filter`'s (scrub verbs must never
    crash the redesign); the LOW end floors at ``5e-4 * rate`` — a
    near-DC cutoff's truncated FIR needs hundreds of thousands of taps
    (the Toeplitz bank for a 1 Hz cutoff at 96 kHz would be ~1 GB).
    """
    nyq = rate / 2
    if float(envelope_cutoff) <= 0:
        return None  # infeasible request disables the envelope
    envelope_cutoff = min(max(float(envelope_cutoff), 5e-4 * rate),
                          0.999 * nyq)
    if highpass_cutoff > 0:
        highpass_cutoff = min(float(highpass_cutoff),
                              0.99 * envelope_cutoff)
    try:
        if highpass_cutoff > 0:
            return butter(
                order, (highpass_cutoff, envelope_cutoff), "bandpass",
                fs=rate, output="sos",
            )
        return butter(order, envelope_cutoff, "lowpass", fs=rate, output="sos")
    except ValueError:
        return None


def sos_pole_radius(sos):
    """Largest pole magnitude of an SOS cascade (stability / decay rate)."""
    sos = np.asarray(sos, dtype=np.float64)
    rmax = 0.0
    for sec in sos:
        a1, a2 = sec[4], sec[5]
        roots = np.roots([1.0, a1, a2]) if (a1 != 0 or a2 != 0) else np.zeros(1)
        if len(roots):
            rmax = max(rmax, float(np.max(np.abs(roots))))
    return rmax


def effective_impulse_length(sos, eps=1e-7, max_len=1 << 20):
    """Number of samples after which the cascade's impulse response has
    decayed below ``eps`` (relative).  Used to size the truncated-FIR fast
    path; the truncation error is then bounded by ``eps``."""
    r = sos_pole_radius(sos)
    if r <= 0.0:
        return 2 * len(np.atleast_2d(sos)) + 1
    if r >= 1.0:
        return max_len
    n = int(np.ceil(np.log(eps) / np.log(r)))
    return int(min(max(n, 8), max_len))


def _cascade_state_space(sos):
    """Single state-space (A, B, C, D) for the whole SOS cascade in
    transposed direct form II coordinates (states stacked per section)."""
    sos = np.asarray(sos, dtype=np.float64)
    ns = len(sos)
    A = np.zeros((2 * ns, 2 * ns))
    B = np.zeros((2 * ns,))
    C = np.zeros((2 * ns,))
    D = 1.0
    # Per-section DF2T: y = b0 x + z1 ; z1' = (b1-a1 b0) x - a1 y_sec... the
    # cascade is built by chaining sections: input of section k is output of
    # section k-1, which is itself affine in (x, states of previous sections).
    for k, sec in enumerate(sos):
        b0, b1, b2, _, a1, a2 = sec
        # Section-local matrices, input u -> output y:
        # s' = M s + K u ;  y = b0 u + [1, 0] s
        M = np.array([[-a1, 1.0], [-a2, 0.0]])
        K = np.array([b1 - a1 * b0, b2 - a2 * b0])
        i = 2 * k
        # u_k = C x + D-chain applied so far (affine in global state + input)
        # New global A/B/C/D after appending this section:
        A[i : i + 2, i : i + 2] = M
        A[i : i + 2, :i] = np.outer(K, C[:i])
        B[i : i + 2] = K * D
        C_new = np.zeros_like(C)
        C_new[:i] = b0 * C[:i]
        C_new[i] = 1.0
        C = C_new
        D = b0 * D
    return A, B, C, D


@dataclasses.dataclass(frozen=True)
class FirKernels:
    """Precomputed (host, float64) responses for the truncated-FIR strategy.

    Attributes
    ----------
    h : (T,) impulse response of the cascade, truncated at the effective
        length.
    state_out : (T, 2*nsec) zero-input output response: output at step n for
        a unit initial value in each state component.
    input_state : (T, 2*nsec) final-state contribution of an input applied
        ``n`` steps before the block end (column j = state component).
    """

    h: np.ndarray
    state_out: np.ndarray
    input_state: np.ndarray
    eps: float
    #: cascade state matrix — carries the initial state across blocks
    #: SHORTER than the kernel (A**n @ s0 has not decayed below eps there)
    A: np.ndarray = None

    @property
    def length(self):
        return self.h.shape[0]


# FirKernels is a pytree (arrays traced, eps static) so a whole design can
# be a jit *argument*: interactive redesigns re-run, never recompile, as
# long as the pow2-bucketed kernel length is unchanged.
jax.tree_util.register_pytree_node(
    FirKernels,
    lambda k: ((k.h, k.state_out, k.input_state, k.A), k.eps),
    lambda eps, ch: FirKernels(ch[0], ch[1], ch[2], eps=eps, A=ch[3]),
)


def fir_kernels(sos, eps=1e-7, max_len=1 << 20, pad_to_pow2=False,
                pad_to=None):
    """Precompute the truncated impulse/state responses of an SOS cascade.

    Uses repeated doubling of the cascade state matrix so design cost is
    ``O(T log T)`` vectorized numpy work, independent of the signal.

    With ``pad_to_pow2`` the responses are extended to the next power of
    two; ``pad_to`` extends to an exact length.  Kernels of equal length
    share compiled programs (they are traced arguments of the jitted data
    path), so fixing the length makes interactive cutoff scrubbing
    recompile-free.  Extension is exact (the responses keep decaying), not
    zero-padding.
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    T = effective_impulse_length(sos, eps, max_len)
    if pad_to is not None:
        T = max(T, int(pad_to))
    if pad_to_pow2:
        T = 1 << (T - 1).bit_length()
    A, B, C, D = _cascade_state_space(sos)
    powers = _matrix_powers(A, T)
    # h[0] = D, h[k] = C A**(k-1) B
    h = np.empty(T)
    h[0] = D
    if T > 1:
        h[1:] = (powers[: T - 1] @ B) @ C
    state_out = np.einsum("tij,i->tj", powers, C)  # row k = C @ A**k
    # state after the block from input x[N-1-j]: A**j B
    input_state = powers @ B  # (T, n)
    return FirKernels(h=h, state_out=state_out, input_state=input_state,
                      eps=eps, A=A)


def filtfilt_sym_kernel(sos, eps=1e-7, max_len=1 << 20, pad_to=None):
    """Symmetric FIR kernel equivalent of zero-phase ``sosfiltfilt``.

    Forward-then-backward IIR filtering of an (effectively) infinite signal
    equals one convolution with the autocorrelation of the impulse
    response: ``g = h (*) reverse(h)``, length ``2T-1``, group delay
    ``T-1``.  One matmul pass instead of two plus two reversals — the batch /
    sharded envelope fast path.  Edge semantics are those of the
    surrounding halo (interior frames match scipy within ``eps``).

    Returns ``(g, delay)``.
    """
    sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
    T = effective_impulse_length(sos, eps, max_len)
    if pad_to is not None:
        T = max(T, int(pad_to))
    h = impulse_response(sos, T)
    g = np.convolve(h, h[::-1])
    return g, T - 1


def impulse_response(sos, T):
    """First ``T`` samples of the cascade's impulse response (float64,
    computed by repeated doubling of the state matrix)."""
    A, B, C, D = _cascade_state_space(
        np.atleast_2d(np.asarray(sos, dtype=np.float64)))
    powers = _matrix_powers(A, T)
    h = np.empty(T)
    h[0] = D
    if T > 1:
        h[1:] = (powers[: T - 1] @ B) @ C
    return h


def _matrix_powers(A, T):
    """``A**k`` for ``k`` in [0, T) by repeated doubling."""
    n = A.shape[0]
    powers = np.empty((T, n, n))
    powers[0] = np.eye(n)
    m = 1
    Am = A.copy()
    while m < T:
        k = min(m, T - m)
        powers[m : m + k] = powers[:k] @ Am
        Am = Am @ Am
        m *= 2
    return powers


def sos_initial_conditions(sos):
    """Steady-state step-response initial conditions, identical to
    ``scipy.signal.sosfilt_zi`` (shape ``(nsec, 2)``)."""
    return sosfilt_zi(np.atleast_2d(np.asarray(sos, dtype=np.float64)))


@dataclasses.dataclass(frozen=True)
class FilterDesign:
    """Complete host-side design bundle for one SOS filter: everything the
    device data path needs, ready to be fed as traced arguments.

    ``None``-valued designs represent the reference's pass-through filter
    state (`src/audian/bufferedfilter.py:41-42`).
    """

    sos: np.ndarray          # (nsec, 6)
    zi0: np.ndarray          # (nsec, 2) steady-state ICs (sosfilt_zi)
    padlen: int              # sosfiltfilt edge padding
    fir: FirKernels          # truncated responses (pow2-bucketed)

    @classmethod
    def from_sos(cls, sos, eps=1e-7, max_len=1 << 20, pad_to=None):
        sos = np.atleast_2d(np.asarray(sos, dtype=np.float64))
        return cls(
            sos=sos,
            zi0=sos_initial_conditions(sos),
            padlen=filtfilt_padlen(sos),
            fir=fir_kernels(sos, eps=eps, max_len=max_len, pad_to=pad_to,
                            pad_to_pow2=True),
        )


jax.tree_util.register_pytree_node(
    FilterDesign,
    lambda d: ((d.sos, d.zi0, d.fir), d.padlen),
    lambda padlen, ch: FilterDesign(ch[0], ch[1], padlen, ch[2]),
)


def filtfilt_padlen(sos):
    """Default edge padding length used by ``scipy.signal.sosfiltfilt``."""
    sos = np.atleast_2d(np.asarray(sos))
    ntaps = 2 * len(sos) + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return int(3 * ntaps)


def ifir_factor(kernel, M=8, Li=None, Lg=None, iters=200):
    """Interpolated-FIR factorization ``kernel ≈ conv(i, upsample(g, M))``.

    The envelope smoothing kernel is a *very* narrowband lowpass (500 Hz
    at 96 kHz → 1 % of Nyquist) truncated to ~1.1 k taps; convolving with
    it directly costs ``2·len(kernel)`` FLOPs per sample.  The classic
    IFIR decomposition (Neuvo/Dong/Mitra 1984) replaces it with a short
    full-rate image-suppressor ``i`` followed by the model filter ``g``
    applied at stride ``M`` (zero-stuffed), cutting FLOPs ~4-5x while the
    device executes both factors as dense matmuls (stage 2 on the
    phase-major stream, so the stride never materializes zeros).

    Factors are fit to the *given* (already truncated) kernel by
    alternating least squares in float64, so the approximation error is a
    measured design-time quantity, not an estimate.  Callers check ``err``
    (the L1 error, which bounds the worst-case output error for unit-peak
    input) against their accuracy budget and fall back to the dense kernel
    if it's too large.

    Returns ``(i, g, err)`` with ``len(i) + (len(g)-1)*M >= len(kernel)``.
    """
    k = np.asarray(kernel, np.float64)
    L = len(k)
    M = int(M)
    if Li is None:
        Li = 12 * M + 1
    if Lg is None:
        Lg = -(-(L - Li) // M) + 3
    n = Li + (Lg - 1) * M
    tgt = np.zeros(n)
    tgt[:L] = k
    # init: windowed-sinc image suppressor at the first image frequency
    t = np.arange(Li) - (Li - 1) / 2
    i = np.sinc(t / M) * np.hamming(Li)
    i /= i.sum()
    g = None
    prev = None
    for _ in range(iters):
        A = np.zeros((n, Lg))
        for j in range(Lg):
            A[j * M : j * M + Li, j] = i
        g, *_ = np.linalg.lstsq(A, tgt, rcond=None)
        B = np.zeros((n, Li))
        for j in range(Lg):
            B[j * M : j * M + Li, :] += g[j] * np.eye(Li)
        i, *_ = np.linalg.lstsq(B, tgt, rcond=None)
        r = float(np.abs(B @ i - tgt).sum())
        if prev is not None and abs(prev - r) < 1e-13:
            break
        prev = r
    A = np.zeros((n, Lg))
    for j in range(Lg):
        A[j * M : j * M + Li, j] = i
    err = float(np.abs(A @ g - tgt).sum())
    return i, g, err


def ifir_factor_auto(kernel, tol, phases=(16, 8, 4), taps=(12, 18, 26)):
    """Pick the most aggressive IFIR factorization within ``tol``.

    Tries stride ``M`` from large to small and image-suppressor lengths
    ``taps[k]*M + 1`` from short to long; returns the first
    ``(i, g, M, err)`` with L1 error ≤ ``tol``, or ``None`` when even the
    gentlest factorization misses (caller falls back to the dense
    kernel).  All work is tiny host-side float64 least squares.
    """
    k = np.asarray(kernel, np.float64)
    for M in phases:
        if len(k) < 24 * M:
            continue
        for t in taps:
            i, g, err = ifir_factor(k, M=M, Li=t * M + 1)
            if err <= tol:
                return i, g, M, err
    return None
