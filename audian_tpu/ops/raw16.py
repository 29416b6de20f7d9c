"""Raw PCM-16 sample conversion shared by every device compute path.

The loader's raw16 convention maps an int16 code ``k`` to the sample
``k / 2**15`` — the same mapping the host WAV decode uses
(`audian_tpu/data/wavio.py`), so dequantizing on device is bit-exact
with decoding on the host.  The multiply is by an exact power of two,
so no rounding happens beyond the int→float convert itself.

One definition serves the interactive window mirror
(`data/data.py`), the chunked graph executor (`graph/executor.py`),
the sharded pipeline (`parallel/pipeline.py`) and the batch chain and
detect envelope (`ops/fused.py`, `ops/envdet.py`).
"""

import jax.numpy as jnp

__all__ = ["RAW16_SCALE", "dequant16"]

#: sample value of int16 code 1 (k / 2^15 convention)
RAW16_SCALE = 1.0 / 32768.0


def dequant16(q):
    """PCM-16 -> f32 on device (``k / 2**15``; exact, matches the host
    decode bit-for-bit).  Traceable — call inside or outside ``jit``."""
    return q.astype(jnp.float32) * jnp.float32(RAW16_SCALE)
