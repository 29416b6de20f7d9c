"""Device mesh construction helpers.

The reference's only parallelism is a host multiprocessing pool
(`src/audian/compresseddata.py:104-122`).  Here parallel execution is laid
out on a ``jax.sharding.Mesh``: a ``seq`` axis shards long recordings in
time (halos are exchanged between neighbouring shards; the cards of a
host reach each other all to all, so the mesh follows the algorithm
alone), a ``ch`` axis
shards channels, and batch work (directories of recordings) maps over
whichever axis is free.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "P", "NamedSharding", "Mesh"]


def make_mesh(devices=None, seq=None, ch=1):
    """Build a ``(seq, ch)`` mesh over ``devices`` (all by default).

    ``seq * ch`` must cover every device; by default all devices go to the
    sequence axis — the natural layout for hour-long single-array
    recordings.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if seq is None:
        seq = n // ch
    if seq * ch != n:
        raise ValueError(f"mesh {seq}x{ch} != {n} devices")
    arr = np.array(devices).reshape(seq, ch)
    return Mesh(arr, axis_names=("seq", "ch"))
