"""Chunk-equivalence tests: chunked + halo execution must equal
whole-array execution for every node and for the full chain — the
property the reference implements but never tests
(`src/audian/buffereddata.py:91-109`, `src/audian/data.py:154-166`);
SURVEY.md section 4 item 2.
"""

import numpy as np
import pytest
import scipy.signal as sps

from audian_tpu.graph import (
    TraceSpec,
    FilterNode,
    EnvelopeNode,
    SpectrogramNode,
    TraceGraph,
    GraphExecutor,
)


RATE = 48000.0


@pytest.fixture(scope="module")
def recording(rng):
    n = int(4.0 * RATE)
    t = np.arange(n) / RATE
    x = (
        np.sin(2 * np.pi * 6000.0 * t) * (np.sin(2 * np.pi * 3.0 * t) > 0)
        + 0.05 * rng.standard_normal(n)
    )
    return np.stack([x, 0.5 * x], axis=1)


def open_graph(frames, channels=2):
    g = TraceGraph()
    g.add(FilterNode("filtered", "data"))
    g.add(EnvelopeNode("envelope", "filtered"))
    g.add(SpectrogramNode("spectrogram", "filtered"))
    spec = TraceSpec(rate=RATE, channels=channels, frames=frames)
    g.open(spec)
    g["filtered"].update(highpass_cutoff=2000.0, lowpass_cutoff=10000.0)
    g.refold()
    return g


def run_whole(g, x):
    ex = GraphExecutor(g)
    return ex.run(x, 0, device=False)


def run_chunked(g, x, chunk):
    """Execute over windows of `chunk` output frames with halo overfetch,
    stitching the results — emulating the interactive scrub path."""
    ex = GraphExecutor(g)
    tb, ta = g.raw_halo
    hb = int(np.ceil(tb * RATE))
    ha = int(np.ceil(ta * RATE))
    n = x.shape[0]
    results = {}
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        r0 = max(start - hb, 0)
        r1 = min(stop + ha, n)
        out = ex.run(x[r0:r1], r0, device=False)
        for name, (off, arr) in out.items():
            dst = results.setdefault(name, {})
            for i in range(arr.shape[0]):
                a = off + i
                # keep the value whose window is most interior
                if name not in ("data",) and a in dst:
                    continue
                dst.setdefault(a, arr[i])
    stitched = {}
    for name, frames in results.items():
        idx = sorted(frames)
        stitched[name] = (idx[0], np.stack([frames[i] for i in idx]))
    return stitched


def test_whole_run_matches_scipy(recording):
    g = open_graph(len(recording))
    out = run_whole(g, recording)
    sos = g["filtered"].design.sos
    want_f = sps.sosfilt(sos, recording, axis=0)
    off, got_f = out["filtered"]
    assert off == 0
    np.testing.assert_allclose(got_f, want_f, atol=1e-6)

    esos = g["envelope"].design.sos
    want_e = sps.sosfiltfilt(esos, (np.pi / 2) * np.abs(want_f), axis=0)
    want_e[want_e < 0] = 0
    off, got_e = out["envelope"]
    np.testing.assert_allclose(got_e, want_e, atol=2e-6)

    f, t, want_s = sps.spectrogram(
        want_f, fs=RATE, window="hann", nperseg=256, noverlap=128,
        detrend=False, scaling="density", mode="psd", axis=0,
    )
    off, got_s = out["spectrogram"]
    assert off == 0
    nf = want_s.shape[2]
    np.testing.assert_allclose(got_s[:nf], want_s.transpose(2, 1, 0),
                               rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("chunk", [4800, 12000])
def test_chunked_equals_whole(recording, chunk):
    g = open_graph(len(recording))
    whole = run_whole(g, recording)
    chunked = run_chunked(g, recording, chunk)
    for name in ["data", "filtered", "envelope", "spectrogram"]:
        off_w, arr_w = whole[name]
        off_c, arr_c = chunked[name]
        assert off_c == off_w == 0
        assert arr_c.shape == arr_w.shape, name
        # IIR warm-up truncation is approximate by design; the halo is
        # sized so the residual is far below the 1e-5 oracle budget.
        np.testing.assert_allclose(arr_c, arr_w, atol=1e-6, err_msg=name)


def test_chunked_respects_laziness(recording):
    g = open_graph(len(recording))
    ex = GraphExecutor(g)
    out = ex.run(recording, 0, targets=["envelope"], device=False)
    assert set(out) == {"data", "filtered", "envelope"}


def test_executor_cache_reused_across_param_changes(recording):
    g = open_graph(len(recording))
    ex = GraphExecutor(g)
    x = recording[:24000]
    ex.run(x, 0, targets=["filtered"])
    n0 = ex.cache_size
    g["filtered"].update(highpass_cutoff=3000.0, lowpass_cutoff=9000.0)
    ex.run(x, 0, targets=["filtered"])
    assert ex.cache_size == n0  # redesign -> same compiled program


def test_executor_offset_geometry(recording):
    """Interior chunks at different aligned offsets share geometry."""
    g = open_graph(len(recording))
    ex = GraphExecutor(g)
    o1 = ex.run(recording[24000:48000], 24000, device=False)
    o2 = ex.run(recording[48000:72000], 48000, device=False)
    assert o1["filtered"][1].shape == o2["filtered"][1].shape


def test_spectrogram_frames_align_with_absolute_grid(recording):
    """Spectrogram frame k must always cover source [k*hop, k*hop+nfft),
    regardless of the chunk it was computed in."""
    g = open_graph(len(recording))
    ex = GraphExecutor(g)
    whole = ex.run(recording, 0, targets=["spectrogram"], device=False)
    off_w, sxx_w = whole["spectrogram"]
    part = ex.run(recording[12800:36800], 12800, targets=["spectrogram"],
                  device=False)
    off_p, sxx_p = part["spectrogram"]
    overlap = min(off_w + sxx_w.shape[0], off_p + sxx_p.shape[0]) - off_p
    np.testing.assert_allclose(
        sxx_p[: overlap], sxx_w[off_p - off_w : off_p - off_w + overlap],
        rtol=1e-6, atol=1e-12,
    )


def test_chain_kernel_chunked_equals_whole(rng):
    """The one-program batch chain (``FusedChainCF.chain_cf``) gives
    identical results whether a recording is processed whole or in
    halo-extended chunks — the batch path's load-bearing invariant."""
    import jax.numpy as jnp
    from audian_tpu.ops import design_filter, design_envelope_filter
    from audian_tpu.ops.fused import FusedChainCF

    rate = 48000.0
    chain = FusedChainCF(rate,
                         filt_sos=design_filter(rate, 1000.0, 8000.0),
                         env_sos=design_envelope_filter(rate, 500.0),
                         nfft=256, hop=128, eps=1e-6)
    ck = chain
    n = 8192
    chunk = 4096
    x = rng.standard_normal((2, ck.hb + n + ck.ha)).astype(np.float32)
    y_w, e_w, s_w = (np.asarray(a) for a in chain.chain_cf(jnp.asarray(x), n))
    for k in range(n // chunk):
        lo = k * chunk
        ext = x[:, lo : lo + ck.hb + chunk + ck.ha]
        y_c, e_c, s_c = (np.asarray(a)
                         for a in chain.chain_cf(jnp.asarray(ext), chunk))
        np.testing.assert_allclose(y_c, y_w[:, lo : lo + chunk], atol=2e-6)
        np.testing.assert_allclose(e_c, e_w[:, lo : lo + chunk], atol=2e-6)
        f0 = lo // 128
        np.testing.assert_allclose(s_c, s_w[f0 : f0 + chunk // 128],
                                   rtol=1e-4, atol=1e-9)


def test_executor_int16_raw_matches_float(recording):
    """An int16 (raw PCM-16) chunk runs the same program family with the
    dequantization fused into the head of the program — outputs equal
    feeding the dequantized float32 chunk, and the "data" trace is the
    dequantized signal (graph/executor.py raw16 convention)."""
    x = np.asarray(recording)
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    xq = (q.astype(np.float32) / 32768.0)
    g = open_graph(len(x))
    ex = GraphExecutor(g)
    out_f = ex.run(xq, 0, device=False)
    out_q = ex.run(q, 0, device=False)
    assert set(out_q) == set(out_f)
    for k in out_f:
        assert out_q[k][0] == out_f[k][0]
        np.testing.assert_array_equal(out_q[k][1], out_f[k][1])
    np.testing.assert_array_equal(out_q["data"][1], xq)
