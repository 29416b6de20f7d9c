"""The XLA strided-window matmul (ops/window_matmul.py) against a numpy
float64 reference over the hops the batch stages use."""

import numpy as np
import pytest

import jax.numpy as jnp

from audian_tpu.ops.window_matmul import window_matmul


def _square(v):
    return v * v


@pytest.mark.parametrize("premap", [None, _square])
@pytest.mark.parametrize("layout", ["fco", "cf"])
@pytest.mark.parametrize("S,K,O", [(128, 384, 128), (90, 256, 258),
                                   (256, 300, 64)])
def test_window_matmul_matches_numpy(rng, S, K, O, layout, premap):
    C, n = 3, 5000
    x = rng.standard_normal((C, n)).astype(np.float32)
    w = rng.standard_normal((K, O)).astype(np.float32)
    # one frame more than the input covers: its window reads zeros
    nframes = (n - K) // S + 2
    out = np.asarray(window_matmul(jnp.asarray(x), jnp.asarray(w), S,
                                   nframes, premap=premap,
                                   out_layout=layout))
    xn = x.astype(np.float64)
    if premap is not None:
        xn = premap(xn)
    xn = np.pad(xn, [(0, 0), (0, nframes * S + K)])
    ref = np.stack([xn[:, f * S : f * S + K] @ w.astype(np.float64)
                    for f in range(nframes)])          # (F, C, O)
    if layout == "cf":
        assert out.shape == (C, nframes * O)
        out = out.reshape(C, nframes, O).transpose(1, 0, 2)
    assert out.shape == (nframes, C, O)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, atol=1e-5 * scale)


def test_window_matmul_int16_premap():
    """An int16 stream with a dequantizing premap equals the float32
    stream it encodes (the raw PCM-16 upload path of EnvDet)."""
    from audian_tpu.ops.envdet import _dequant

    q = (np.arange(4 * 1024) % 65536 - 32768).astype(np.int16)
    q = q.reshape(4, 1024)
    w = np.eye(128, dtype=np.float32)
    got = window_matmul(jnp.asarray(q), jnp.asarray(w), 128, 8,
                        premap=_dequant, out_layout="cf")
    np.testing.assert_array_equal(
        np.asarray(got), q.astype(np.float32) / 32768.0)


def test_window_matmul_no_frames():
    x = jnp.zeros((2, 100), jnp.float32)
    w = jnp.ones((256, 129), jnp.float32)
    assert window_matmul(x, w, 128, 0).shape == (0, 2, 129)
