"""Collective primitives: halo exchange over the sequence axis.

The reference's chunk-overlap protocol re-reads halo samples from the
source buffer on the host (`src/audian/buffereddata.py:91-109`).  Sharded
across devices, the same halos are fetched from the *neighbor shard* with
``jax.lax.ppermute`` — one neighbor hop per direction, the direct
analog of ring attention's neighbor exchange (SURVEY.md section 5.7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["halo_exchange"]


def halo_exchange(x, before, after, axis_name="seq"):
    """Extend a time shard with ``before`` trailing frames of the left
    neighbor and ``after`` leading frames of the right neighbor.

    Runs inside ``shard_map``.  Edge shards receive zeros — identical to
    zero initial conditions at the start of a recording, and to the global
    zero padding the batch pipeline applies at the end.

    Parameters
    ----------
    x : (L, ...) local time shard.
    before, after : static halo frame counts (may be 0).
    axis_name : mesh axis to exchange over.

    Returns (before + L + after, ...).
    """
    if max(before, after) > x.shape[0]:
        # jnp slice clipping would silently return a shorter "halo" made
        # of the shard's own samples, misaligning every downstream slice
        raise ValueError(
            f"halo ({before}, {after}) exceeds the local shard length "
            f"{x.shape[0]}: one neighbor exchange cannot provide it")
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    parts = []
    if before > 0:
        tail = x[-before:]
        # shard i receives shard i-1's tail
        left = lax.ppermute(tail, axis_name,
                            perm=[(i, (i + 1) % n) for i in range(n)])
        left = jnp.where(idx > 0, left, jnp.zeros_like(left))
        parts.append(left)
    parts.append(x)
    if after > 0:
        head = x[:after]
        # shard i receives shard i+1's head
        right = lax.ppermute(head, axis_name,
                             perm=[(i, (i - 1) % n) for i in range(n)])
        right = jnp.where(idx < n - 1, right, jnp.zeros_like(right))
        parts.append(right)
    return jnp.concatenate(parts, axis=0)
