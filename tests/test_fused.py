"""Fused channels-first chain vs scipy oracles and its own stages."""

import numpy as np
import pytest
import scipy.signal as sps

from audian_tpu.ops import design_filter, design_envelope_filter
from audian_tpu.ops.fused import FusedChainCF


RATE = 48000.0


@pytest.fixture(scope="module")
def signal(rng):
    n = 20000
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 6.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, 0.5 * x], axis=0).astype(np.float32)  # (C, n)


@pytest.fixture(scope="module")
def chain():
    return FusedChainCF(
        RATE,
        filt_sos=design_filter(RATE, 1000.0, 8000.0),
        env_sos=design_envelope_filter(RATE, 500.0),
        nfft=256, hop=128, eps=1e-8,
    )


def test_filtered_matches_scipy(chain, signal):
    got = np.asarray(chain.filtered_cf(signal))
    want = sps.sosfilt(design_filter(RATE, 1000.0, 8000.0),
                       signal.astype(np.float64), axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_envelope_matches_scipy_interior(chain, signal):
    y = sps.sosfilt(design_filter(RATE, 1000.0, 8000.0),
                    signal.astype(np.float64), axis=1)
    want = sps.sosfiltfilt(design_envelope_filter(RATE, 500.0),
                           (np.pi / 2) * np.abs(y), axis=1)
    want[want < 0] = 0
    got = np.asarray(chain.envelope_cf(jnp_array(y)))
    d = chain.env_delay
    np.testing.assert_allclose(got[:, d:-d], want[:, d:-d], atol=1e-5)


def jnp_array(x):
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x, np.float32))


def test_spectrogram_matches_scipy(chain, signal):
    y = signal.astype(np.float64)
    _, _, want = sps.spectrogram(
        y, fs=RATE, window="hann", nperseg=256, noverlap=128,
        detrend=False, scaling="density", mode="psd", axis=1)
    got = np.asarray(chain.spectrogram_fc(jnp_array(y)))
    # scipy axis=1 -> (C, freq, time); ours (time, C, freq)
    np.testing.assert_allclose(got, want.transpose(2, 0, 1), rtol=1e-5,
                               atol=1e-10)


def test_ifir_envelope_matches_dense(signal):
    """The two-stage IFIR envelope equals the dense symmetric-kernel
    convolution within the fit tolerance (design.ifir_factor docstring)."""
    kw = dict(filt_sos=None,
              env_sos=design_envelope_filter(RATE, 500.0), eps=1e-8)
    ifir = FusedChainCF(RATE, ifir=True, **kw)
    dense = FusedChainCF(RATE, ifir=False, **kw)
    assert ifir.env_mode == "ifir" and dense.env_mode == "dense"
    x = jnp_array(signal)
    got = np.asarray(ifir.envelope_cf(x))
    want = np.asarray(dense.envelope_cf(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-6)


def test_ifir_odd_length_stream(signal):
    """IFIR path pads non-multiple-of-M lengths correctly."""
    chain = FusedChainCF(RATE, env_sos=design_envelope_filter(RATE, 500.0),
                         eps=1e-6)
    x = jnp_array(signal[:, :19997])
    e = np.asarray(chain.envelope_cf(x))
    assert e.shape == (2, 19997)
    e2 = np.asarray(chain.envelope_cf(jnp_array(signal)))
    # the final env_delay samples legitimately differ (they depend on
    # samples beyond the truncated stream, zero-padded here)
    valid = 19997 - chain.env_delay
    np.testing.assert_allclose(e[:, :valid], e2[:, :valid], atol=1e-6)


def test_single_pass_chain_matches_stages(chain, signal):
    """The one-program chain (``chain_cf``) produces the same
    filtered/envelope/PSD values as the per-stage path."""
    import jax.numpy as jnp

    assert chain.hb is not None
    C, n_all = signal.shape
    n = 2048  # output region, a multiple of 128
    x = jnp_array(signal)
    # extended stream for the one-program chain
    x_ext = jnp.pad(x, [(0, 0), (chain.hb, 0)])
    y1, e1, s1 = chain.chain_cf(x_ext, n)
    # per-stage oracle over the same stream semantics
    y_ref = np.asarray(chain.filtered_cf(x))
    e_ref = np.asarray(chain.envelope_cf(jnp_array(y_ref)))
    s_ref = np.asarray(chain.spectrogram_fc(jnp_array(y_ref),
                                            nframes=n // 128))
    np.testing.assert_allclose(np.asarray(y1), y_ref[:, :n], atol=2e-6)
    # envelope interior (edges depend on halo treatment)
    d = chain.env_delay
    np.testing.assert_allclose(np.asarray(e1)[:, d:n - d],
                               e_ref[:, d:n - d], atol=3e-6)
    np.testing.assert_allclose(np.asarray(s1), s_ref, rtol=1e-4,
                               atol=1e-9)


def test_full_chain_shapes(chain, signal):
    out = chain(signal)
    C, n = signal.shape
    assert out["filtered"].shape == (C, n)
    assert out["envelope"].shape == (C, n)
    nf = (n - 256) // 128 + 1
    assert out["spectrogram"].shape == (nf, C, 129)


@pytest.mark.parametrize("nfft,ch", [(512, 4), (128, 1)])
def test_single_pass_chain_geometries(rng, nfft, ch):
    """The one-program chain handles other NFFT buckets and channel
    counts."""
    import jax.numpy as jnp

    chain = FusedChainCF(RATE,
                         filt_sos=design_filter(RATE, 1000.0, 8000.0),
                         env_sos=design_envelope_filter(RATE, 500.0),
                         nfft=nfft, hop=128, eps=1e-6)
    ck = chain
    assert ck.hb is not None
    n = 1024
    x = jnp.asarray(rng.standard_normal(
        (ch, ck.hb + n + ck.ha)).astype(np.float32))
    y, e, s = chain.chain_cf(x, n)
    assert y.shape == (ch, n) and e.shape == (ch, n)
    assert s.shape == (n // 128, ch, nfft // 2 + 1)
    y_ref = np.asarray(chain.filtered_cf(x))[:, ck.hb : ck.hb + n]
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=2e-6)
    s_ref = np.asarray(chain.spectrogram_fc(
        jnp.asarray(np.asarray(chain.filtered_cf(x))[:, ck.hb:]),
        nframes=n // 128))
    np.testing.assert_allclose(np.asarray(s), s_ref, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("n", [2048, 1920, 1000])
def test_single_pass_chain_stats(chain, rng, n):
    """Chunk statistics equal reductions of the full outputs, including
    when ``n`` is not a multiple of the filter block."""
    import jax.numpy as jnp

    ck = chain
    x = jnp.asarray(rng.standard_normal(
        (2, ck.hb + n + ck.ha)).astype(np.float32))
    y, e, s, st = chain.chain_cf(x, n, stats=True)
    np.testing.assert_allclose(np.asarray(st["power"]),
                               np.sum(np.asarray(y) ** 2, axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st["env_sum"]),
                               np.sum(np.asarray(e), axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(st["psd_sum"]),
                               np.sum(np.asarray(s), axis=0),
                               rtol=1e-5, atol=1e-9)


def test_single_pass_chain_int16_input(chain, signal):
    """int16 (raw PCM-16) input is dequantized on the device with the
    loader's k/2^15 convention and gives exactly the same outputs as
    feeding the dequantized float32 stream (half the upload bytes)."""
    import jax.numpy as jnp

    ck = chain
    n = 2048
    x = jnp.pad(jnp_array(signal), [(0, 0), (ck.hb, 0)])
    q = jnp.clip(jnp.round(x * 32768.0), -32768, 32767).astype(jnp.int16)
    xq = q.astype(jnp.float32) / 32768.0
    y_f, e_f, s_f = chain.chain_cf(xq, n)
    y_q, e_q, s_q = chain.chain_cf(q, n)
    np.testing.assert_array_equal(np.asarray(y_q), np.asarray(y_f))
    np.testing.assert_array_equal(np.asarray(e_q), np.asarray(e_f))
    np.testing.assert_array_equal(np.asarray(s_q), np.asarray(s_f))


def test_single_pass_chain_output_mask(chain, signal):
    """The static ``outputs`` mask returns exactly the requested stages
    with values identical to the full chain (masked positions are None,
    their stats report zero) — batch consumers that need only one output
    skip the other stages."""
    import itertools

    import jax.numpy as jnp

    ck = chain
    n = 2048
    x = jnp.pad(jnp_array(signal), [(0, 0), (ck.hb, 0)])
    y0, e0, s0, st0 = chain.chain_cf(x, n, stats=True)
    names = ("filtered", "envelope", "spectrogram")
    refs = dict(zip(names, (y0, e0, s0)))
    for r in (1, 2):
        for outputs in itertools.combinations(names, r):
            got = chain.chain_cf(x, n, stats=True, outputs=outputs)
            *vals, st = got
            for name, val in zip(names, vals):
                if name in outputs:
                    np.testing.assert_array_equal(
                        np.asarray(val), np.asarray(refs[name]),
                        err_msg=f"{name} with outputs={outputs}")
                else:
                    assert val is None, (name, outputs)
            for key, name in (("power", "filtered"),
                              ("env_sum", "envelope"),
                              ("psd_sum", "spectrogram")):
                if name in outputs:
                    np.testing.assert_array_equal(np.asarray(st[key]),
                                                  np.asarray(st0[key]))
                else:
                    assert not np.any(np.asarray(st[key]))


def test_chain_output_mask_rejects_bad_names(chain, signal):
    import jax.numpy as jnp

    x = jnp.zeros((2, chain.hb + 256), jnp.float32)
    with pytest.raises(ValueError, match="outputs"):
        chain.chain_cf(x, 128, outputs=("psd",))
    with pytest.raises(ValueError, match="outputs"):
        chain.chain_cf(x, 128, outputs=())


def test_fused_call_output_mask(chain, signal):
    """The per-stage ``FusedChainCF.__call__`` honors the same mask."""
    full = chain(signal)
    env_only = chain(signal, outputs=("envelope",))
    assert set(env_only) == {"envelope"}
    np.testing.assert_array_equal(np.asarray(env_only["envelope"]),
                                  np.asarray(full["envelope"]))


@pytest.mark.parametrize("outputs", [
    ("filtered",), ("envelope",), ("spectrogram",),
    ("filtered", "envelope"), ("filtered", "spectrogram"),
    ("envelope", "spectrogram"),
    ("filtered", "envelope", "spectrogram")])
@pytest.mark.parametrize("hop", [128, 64])
def test_chain_cf_matches_stage_composition(rng, outputs, hop):
    """``chain_cf`` under every output mask equals the per-stage methods
    composed over the same extended stream, and its stats equal
    reductions of those stage outputs (zero for masked stages)."""
    import jax.numpy as jnp

    chain = FusedChainCF(RATE,
                         filt_sos=design_filter(RATE, 1000.0, 8000.0),
                         env_sos=design_envelope_filter(RATE, 500.0),
                         nfft=256, hop=hop, eps=1e-6)
    n = 1536
    x = rng.standard_normal((2, chain.hb + n + chain.ha)).astype(np.float32)
    *vals, st = chain.chain_cf(jnp.asarray(x), n, stats=True,
                               outputs=outputs)
    y_full = np.asarray(chain.filtered_cf(jnp.asarray(x)))
    lead = chain.hb - chain.filt_halo
    y_ref = y_full[:, chain.hb : chain.hb + n]
    # envelope of the stream that starts lead samples early, cropped
    e_ref = np.asarray(chain.envelope_cf(
        jnp.asarray(y_full[:, chain.filt_halo :])))[:, lead : lead + n]
    s_ref = np.asarray(chain.spectrogram_fc(
        jnp.asarray(y_full[:, chain.hb :]), nframes=n // hop))
    refs = {"filtered": y_ref, "envelope": e_ref, "spectrogram": s_ref}
    names = ("filtered", "envelope", "spectrogram")
    stat_of = {"filtered": ("power", lambda v: np.sum(v * v, axis=1)),
               "envelope": ("env_sum", lambda v: np.sum(v, axis=1)),
               "spectrogram": ("psd_sum", lambda v: np.sum(v, axis=0))}
    for name, val in zip(names, vals):
        key, reduce = stat_of[name]
        if name not in outputs:
            assert val is None
            assert not np.any(np.asarray(st[key]))
            continue
        got = np.asarray(val)
        assert got.shape == refs[name].shape, name
        if name == "spectrogram":
            np.testing.assert_allclose(got, refs[name], rtol=1e-4,
                                       atol=1e-9)
        else:
            # the envelope reference's right edge sees zero padding past
            # the extended stream only beyond n + delay: none inside n
            np.testing.assert_allclose(got, refs[name], atol=2e-6)
        np.testing.assert_allclose(np.asarray(st[key]), reduce(got),
                                   rtol=1e-5, atol=1e-6)
