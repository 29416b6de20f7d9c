"""audian-tpu: a JAX framework for interactive analysis of animal
vocalization recordings.

A ground-up JAX/XLA rebuild with the capabilities of the reference
audian package (bendalab/audian): a lazy, chunked, demand-driven DSP dataflow
graph over out-of-core audio (raw -> Butterworth filter -> envelope /
spectrogram), plugin-extensible derived traces and analyzers, min/max pyramid
decimation for overview rendering, region analysis/export, audio playback
with heterodyne down-mixing, and batch CLIs -- all with the hot compute path
on the accelerator (a GPU).

Layering (mirrors SURVEY.md section 1 of the rebuild plan):

- ``audian_tpu.ops``       device kernels (SOS IIR, STFT, envelope, min/max, mix)
- ``audian_tpu.graph``     functional lazy trace DAG with halo folding
- ``audian_tpu.data``      audio I/O, out-of-core loader, ``Data`` registry
- ``audian_tpu.parallel``  device-mesh sharding (channel / chunk / sequence)
- ``audian_tpu.stream``    host-side window scheduler feeding the device
- ``audian_tpu.view``      Qt-free view-model (panels, ranges, axes, markers)
- ``audian_tpu.analysis``  analyzer protocol + plugin discovery
- ``audian_tpu.cache``     fulltrace pyramid cache artifacts
- ``audian_tpu.cli``       ``audian``, ``audian-compress``, ``songdetector``
"""

import os
from pathlib import Path

from .version import __version__, __year__, audian_dirs

__all__ = ["__version__", "__year__", "audian_dirs",
           "enable_compilation_cache"]


_cache_enabled = False

#: the persistent compilation cache's default directory: fixed and inside
#: the checkout, so every later session of this checkout finds it
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compilation_cache():
    """Enable JAX's persistent compilation cache and return its
    directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and no other
    directory is set here; otherwise the cache lives in
    :data:`DEFAULT_CACHE_DIR`.  With the cache every later session reuses
    the chain's compiled programs.  Called automatically by
    :meth:`audian_tpu.data.Data.open` and the CLIs.
    """
    global _cache_enabled
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not _cache_enabled:
        if not env:
            DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
            jax.config.update("jax_compilation_cache_dir",
                              str(DEFAULT_CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        _cache_enabled = True
    return Path(env) if env else DEFAULT_CACHE_DIR
