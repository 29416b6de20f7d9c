"""Device compute kernels for audian-tpu.

Everything here is pure JAX (XLA) plus tiny host-side design helpers;
these kernels replace the reference's scipy/numpy hot paths (see SURVEY.md
section 2, "Native / accelerated components").
"""

from .design import (
    design_filter,
    design_envelope_filter,
    fir_kernels,
    FirKernels,
    FilterDesign,
    effective_impulse_length,
    impulse_response,
    filtfilt_sym_kernel,
    sos_pole_radius,
    sos_initial_conditions,
    filtfilt_padlen,
)
from .sos import (
    sosfilt,
    sosfilt_fir,
    sosfiltfilt,
    sosfiltfilt_fir,
    sosfiltfilt_sym,
    sosfilt_zi,
    odd_ext,
)
from .stft import (
    spectrogram,
    spectrogram_frequencies,
    hann_window,
    frame_signal,
    num_frames,
    decibel,
    inverse_decibel,
)
from .envelope import envelope
from .minmax import (
    minmax_decimate,
    minmax_interleaved,
    interleave_minmax,
    minmax_pyramid,
    pyramid_levels,
)
from .mix import stereo_mixdown, heterodyne, fade, prepare_playback

__all__ = [
    "design_filter", "design_envelope_filter", "fir_kernels", "FirKernels",
    "FilterDesign",
    "effective_impulse_length", "impulse_response", "filtfilt_sym_kernel",
    "sos_pole_radius", "sos_initial_conditions", "filtfilt_padlen",
    "sosfilt", "sosfilt_fir", "sosfiltfilt", "sosfiltfilt_fir",
    "sosfiltfilt_sym", "sosfilt_zi", "odd_ext",
    "spectrogram", "spectrogram_frequencies", "hann_window", "frame_signal",
    "num_frames", "decibel", "inverse_decibel",
    "envelope",
    "minmax_decimate", "minmax_interleaved", "interleave_minmax",
    "minmax_pyramid", "pyramid_levels",
    "stereo_mixdown", "heterodyne", "fade", "prepare_playback",
]

from .sweep import spectrogram_sweep, db_quantize, SWEEP_NFFTS

__all__ += ["spectrogram_sweep", "db_quantize", "SWEEP_NFFTS"]
