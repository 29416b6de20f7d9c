"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(SURVEY.md section 4 item 4): halo exchange, sharded-vs-whole equivalence,
channel sharding."""

import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from audian_tpu.ops import FilterDesign, design_filter, design_envelope_filter
from audian_tpu.parallel import make_mesh, halo_exchange, ShardedPipeline


RATE = 48000.0


@pytest.fixture(scope="module")
def signal(rng):
    n = 1 << 17
    t = np.arange(n) / RATE
    x = np.sin(2 * np.pi * 5000.0 * t) * (np.sin(2 * np.pi * 4.0 * t) > 0)
    x = x + 0.05 * rng.standard_normal(n)
    return np.stack([x, 0.5 * x], axis=1).astype(np.float32)


def test_halo_exchange_roundtrip():
    mesh = make_mesh(seq=8, ch=1)
    n, b, a = 64, 5, 3
    x = np.arange(n * 8, dtype=np.float32).reshape(8 * n, 1)

    fn = jax.jit(jax.shard_map(
        lambda xs: halo_exchange(xs, b, a, "seq"),
        mesh=mesh, in_specs=P("seq", None), out_specs=P("seq", None),
    ))
    out = np.asarray(fn(x)).reshape(8, n + b + a)
    # interior shard 3: full halos from both neighbors
    np.testing.assert_array_equal(
        out[3], np.arange(3 * n - b, 4 * n + a, dtype=np.float32))
    # first shard: zero left halo
    assert np.all(out[0][:b] == 0)
    np.testing.assert_array_equal(out[0][b:], np.arange(0, n + a))
    # last shard: zero right halo
    assert np.all(out[7][-a:] == 0)


@pytest.mark.parametrize("seq,ch", [(8, 1), (4, 2)])
def test_sharded_pipeline_matches_whole(signal, seq, ch):
    mesh = make_mesh(seq=seq, ch=ch)
    filt = FilterDesign.from_sos(design_filter(RATE, 1000.0, 8000.0))
    env = FilterDesign.from_sos(design_envelope_filter(RATE, 500.0))
    pipe = ShardedPipeline(mesh, RATE, filt=filt, env=env, nfft=256,
                           minmax_step=512)
    out = pipe(signal)
    n = len(signal)

    want_f = sps.sosfilt(filt.sos, signal.astype(np.float64), axis=0)
    got_f = np.asarray(out["filtered"])[:n]
    np.testing.assert_allclose(got_f, want_f, atol=1e-5)

    want_e = sps.sosfiltfilt(env.sos, (np.pi / 2) * np.abs(want_f), axis=0)
    want_e[want_e < 0] = 0
    got_e = np.asarray(out["envelope"])[:n]
    # global head/tail: zero-pad vs scipy's odd reflection — a documented
    # bounded edge artifact within one envelope halo of the recording ends;
    # the interior must agree strictly
    edge = 2 * (env.fir.length + env.padlen)
    np.testing.assert_allclose(got_e[edge:-edge], want_e[edge:-edge],
                               atol=1e-5)
    assert np.all(np.isfinite(got_e))

    _, _, want_s = sps.spectrogram(
        want_f, fs=RATE, window="hann", nperseg=256, noverlap=128,
        detrend=False, scaling="density", mode="psd", axis=0)
    got_s = np.asarray(out["spectrogram"])
    nf = want_s.shape[2]
    np.testing.assert_allclose(got_s[:nf], want_s.transpose(2, 1, 0),
                               rtol=1e-4, atol=1e-9)

    mm = np.asarray(out["minmax"])
    assert mm.shape == (2 * pipe.padded_length(n) // 512, 2)
    np.testing.assert_allclose(mm[0, 0], signal[:512, 0].min(), atol=1e-7)
    np.testing.assert_allclose(mm[1, 0], signal[:512, 0].max(), atol=1e-7)


def test_sharded_pipeline_no_filter(signal):
    mesh = make_mesh(seq=8, ch=1)
    pipe = ShardedPipeline(mesh, RATE, filt=None, env=None, nfft=512)
    out = pipe(signal)
    assert set(out) == {"filtered", "spectrogram"}
    n = len(signal)
    np.testing.assert_allclose(np.asarray(out["filtered"])[:n], signal,
                               atol=0)


def test_output_shardings(signal):
    mesh = make_mesh(seq=8, ch=1)
    filt = FilterDesign.from_sos(design_filter(RATE, 1000.0, 8000.0))
    pipe = ShardedPipeline(mesh, RATE, filt=filt, env=None)
    out = pipe(signal)
    shard = out["filtered"].sharding
    assert shard.spec == P("seq", "ch")
    assert len(out["filtered"].devices()) == 8


# -- file-level batch data parallelism (parallel/batch.py) --------------------


def test_map_files_matches_sequential(rng):
    import jax
    import jax.numpy as jnp
    from audian_tpu.parallel import map_files

    files = [f"f{i}" for i in range(13)]
    seen_devices = []

    def fn(path):
        i = int(path[1:])
        x = jnp.asarray(rng.standard_normal(256).astype(np.float32) * 0 + i)
        y = jnp.sum(x * 2.0)
        seen_devices.append(list(y.devices())[0])
        return float(y)

    got = map_files(fn, files)
    assert got == [i * 512.0 for i in range(13)]
    # the work actually spread over the virtual mesh
    assert len(set(seen_devices)) > 1


def test_map_files_propagates_errors():
    from audian_tpu.parallel import map_files

    def fn(path):
        if path == "bad":
            raise ValueError("boom")
        return path

    with pytest.raises(ValueError, match="boom"):
        map_files(fn, ["a", "bad", "c", "d"])
    # sequential fallback with a single worker
    assert map_files(fn, ["a", "b"], max_workers=1) == ["a", "b"]


def test_map_files_returned_exception_is_a_result():
    """An exception object ``fn`` RETURNS (a per-file error-report
    value) is an ordinary result — only raised exceptions are gathered
    and re-raised after the batch."""
    from audian_tpu.parallel import map_files

    err = ValueError("report, not failure")

    def fn(path):
        return err if path == "b" else path

    for workers in (1, None):
        got = map_files(fn, ["a", "b", "c"], max_workers=workers)
        assert got == ["a", err, "c"]


def test_songdetector_cli_parallel(tmp_path, rng):
    from audian_tpu.cli import songdetector
    from audian_tpu.data import wavio

    rate = 20000.0
    t = np.arange(int(rate * 8)) / rate
    x = 0.02 * rng.standard_normal(len(t))
    for s in (2.0, 5.0):
        m = (t >= s) & (t < s + 1.2)
        am = 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[m]))
        x[m] += 0.6 * am * np.sin(2 * np.pi * 6500.0 * t[m])
    paths = []
    for i in range(3):
        p = tmp_path / f"rec{i}.wav"
        wavio.write_audio(p, x[:, None], rate, encoding="FLOAT")
        paths.append(str(p))
    assert songdetector.main(["-j", "0", *paths]) == 0
    tables = sorted(tmp_path.glob("rec*-songs.csv"))
    assert len(tables) == 3
    texts = [p.read_text() for p in tables]
    assert texts[0] == texts[1] == texts[2]
    assert len(texts[0].strip().splitlines()) == 3  # header + 2 songs


def _detect_signal(rng, n, rate, channels):
    t = np.arange(n) / rate
    tone = 0.4 * np.sin(2 * np.pi * 6500.0 * t) * (
        np.sin(2 * np.pi * 2.0 * t) > 0)
    x = tone[:, None] + 0.05 * rng.standard_normal((n, channels))
    return np.clip(np.round(x * 32768), -32768, 32767)


@pytest.mark.parametrize("dtype,channels,seq", [(np.int16, 3, 8),
                                                (np.float32, 1, 8),
                                                (np.int16, 2, 4),
                                                (np.float32, 2, 2)])
def test_sharded_band_env_matches_chunked(rng, dtype, channels, seq):
    """The mesh path of the batch detect envelope == the single-device
    chunked path EVERYWHERE, including the exact-patched recording
    edges (parallel/detect.py) — across mesh widths."""
    from audian_tpu.analysis import events

    rate = 96000.0
    n = (1 << 19) + 4321  # non-aligned length exercises the padding
    q = _detect_signal(rng, n, rate, channels)
    x = q.astype(dtype) if dtype == np.int16 else \
        (q / 32768.0).astype(np.float32)
    if seq == 8:
        mesh = make_mesh(seq=8, ch=1)
    else:  # seq-only submesh, the CLI's own construction
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:seq]).reshape(seq),
                    ("seq",))
    _f, ref, er = events.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                  return_filtered=False)
    _f2, got, er2 = events.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                    return_filtered=False, mesh=mesh)
    assert er == er2
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    scale = float(np.max(np.abs(ref)))
    assert np.max(np.abs(ref - got)) / scale < 1e-5


def test_sharded_band_env_shape_bucketing(rng, monkeypatch):
    """Different recording lengths in the same quarter-pow2 bucket
    reuse ONE compiled program (the no-unbounded-chunk-shapes rule)."""
    from audian_tpu.analysis import events
    from audian_tpu.parallel import detect as pdetect

    pdetect._PROGRAMS.clear()
    # neutralize the process-sticky kernel budgets other tests pumped —
    # an inflated halo would make these lengths decline to shard at all
    monkeypatch.setattr(events, "_KERNEL_BUDGET",
                        {"filt": 0, "env": 0})
    mesh = make_mesh(seq=8, ch=1)
    rate = 96000.0
    for extra in (0, 7777, 15000):
        n = (1 << 19) + extra
        x = (0.1 * rng.standard_normal((n, 1))).astype(np.float32)
        _f, env, _er = events.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                       return_filtered=False, mesh=mesh)
        assert len(env) == -(-n // 19)
    assert len(pdetect._PROGRAMS) == 1


def test_sharded_band_env_geometry_fuzz(rng, monkeypatch):
    """Randomized lengths/channels/cutoffs through the sharded path
    vs the chunked oracle — the chunked == sharded contract is
    load-bearing (CLAUDE.md architecture invariants), so it gets the
    same fuzz treatment as the chunk-equivalence suite."""
    from audian_tpu.analysis import events

    monkeypatch.setattr(events, "_KERNEL_BUDGET",
                        {"filt": 0, "env": 0})
    mesh = make_mesh(seq=8, ch=1)
    for trial in range(4):
        rate = float(rng.choice([44100.0, 96000.0]))
        n = int(rng.integers(1 << 19, (1 << 19) + 120000))
        ch = int(rng.integers(1, 4))
        hp = float(rng.uniform(500, 2000))
        lp = float(rng.uniform(6000, 12000))
        x = (0.1 * rng.standard_normal((n, ch))).astype(np.float32)
        _f, ref, er = events.band_env(x, rate, hp, lp, 500.0,
                                      return_filtered=False)
        _f2, got, er2 = events.band_env(x, rate, hp, lp, 500.0,
                                        return_filtered=False,
                                        mesh=mesh)
        assert er == er2
        ref, got = np.asarray(ref), np.asarray(got)
        assert ref.shape == got.shape, (trial, ref.shape, got.shape)
        scale = max(float(np.max(np.abs(ref))), 1e-9)
        err = float(np.max(np.abs(ref - got))) / scale
        assert err < 1e-5, (trial, rate, n, ch, hp, lp, err)


def test_sharded_band_env_short_recording_falls_back(rng):
    """Below the shardable size the mesh path declines and the chunked
    driver serves the call — identical output either way."""
    from audian_tpu.analysis import events

    rate = 48000.0
    x = (0.1 * rng.standard_normal((20000, 2))).astype(np.float32)
    mesh = make_mesh(seq=8, ch=1)
    _f, ref, _er = events.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                   return_filtered=False)
    _f2, got, _er2 = events.band_env(x, rate, 1000.0, 10000.0, 500.0,
                                     return_filtered=False, mesh=mesh)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_detect_on_mesh_equals_single_device(rng):
    """detect(mesh=...) returns the same events as the single-device
    run (the decimated envelopes agree to f32, so the host
    postprocessing sees identical inputs)."""
    from audian_tpu.analysis import events

    rate = 96000.0
    n = 1 << 19
    x = _detect_signal(rng, n, rate, 2).astype(np.int16)
    mesh = make_mesh(seq=8, ch=1)
    ref = events.detect(x, rate, verbose=0, return_filtered=False)
    got = events.detect(x, rate, verbose=0, return_filtered=False,
                        mesh=mesh)
    assert got["filtered"] is None
    for c in range(2):
        np.testing.assert_allclose(got["onsets"][c], ref["onsets"][c],
                                   atol=1.0 / got["envrate"])
        np.testing.assert_allclose(got["offsets"][c], ref["offsets"][c],
                                   atol=1.0 / got["envrate"])
    np.testing.assert_allclose(got["thresholds"], ref["thresholds"],
                               rtol=1e-4)


def test_songdetector_cli_mesh(tmp_path, rng):
    """--mesh 0 shards each recording over the whole virtual mesh and
    produces the same event table as the single-device run."""
    from audian_tpu.cli import songdetector
    from audian_tpu.data import wavio

    rate = 48000.0
    n = 1 << 19
    t = np.arange(n) / rate
    x = 0.02 * rng.standard_normal(n)
    for s in (2.0, 6.0):
        m = (t >= s) & (t < s + 1.5)
        am = 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t[m]))
        x[m] += 0.6 * am * np.sin(2 * np.pi * 6500.0 * t[m])
    p = tmp_path / "mesh.wav"
    wavio.write_audio(p, x[:, None], rate, encoding="PCM_16")
    assert songdetector.main([str(p)]) == 0
    single = (tmp_path / "mesh-songs.csv").read_text()
    (tmp_path / "mesh-songs.csv").unlink()
    assert songdetector.main(["--mesh", "0", str(p)]) == 0
    sharded = (tmp_path / "mesh-songs.csv").read_text()
    assert sharded == single
    assert len(single.strip().splitlines()) == 3  # header + 2 songs


def test_sharded_halo_exceeds_shard_raises():
    """A halo longer than the per-shard length cannot come from one
    neighbor exchange; must fail loudly instead of corrupting output."""
    import scipy.signal as sps
    from audian_tpu.ops import FilterDesign
    from audian_tpu.parallel import make_mesh, ShardedPipeline

    mesh = make_mesh(seq=8, ch=1)
    # 10 Hz order-2 highpass at 96 kHz: ~tens of thousands of FIR taps
    filt = FilterDesign.from_sos(
        sps.butter(2, 10.0, "highpass", fs=96000.0, output="sos"))
    pipe = ShardedPipeline(mesh, 96000.0, filt=filt, env=None,
                           spectrogram=False)
    x = np.zeros((8 * 4096, 1), np.float32)
    with pytest.raises(ValueError, match="halo"):
        pipe(x)


def test_map_files_sequential_continues_after_error():
    from audian_tpu.parallel import map_files

    seen = []

    def fn(path):
        seen.append(path)
        if path == "bad":
            raise ValueError("boom")
        return path

    with pytest.raises(ValueError, match="boom"):
        map_files(fn, ["a", "bad", "c"], max_workers=1)
    assert seen == ["a", "bad", "c"]  # kept going past the failure


def test_halo_exchange_lowers_to_collective_permute():
    """The sequence-sharded halo exchange must lower to neighbor
    collective-permute ops (the neighbour ring of SURVEY.md section 5.7), not
    to all-gathers that would move whole shards."""
    mesh = make_mesh(seq=8, ch=1)
    fn = jax.jit(jax.shard_map(
        lambda xs: halo_exchange(xs, 5, 3, "seq"),
        mesh=mesh, in_specs=P("seq", None), out_specs=P("seq", None)))
    x = jax.ShapeDtypeStruct((512, 1), jnp.float32)
    hlo = fn.lower(x).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo


def test_seq1_mesh_handles_short_clips(signal):
    """A degenerate one-shard mesh has no neighbors — halos are local
    zero padding, so clips shorter than the kernel must work and match
    scipy exactly."""
    mesh = make_mesh(seq=1, ch=1, devices=jax.devices()[:1])
    sos = design_filter(RATE, 2000.0, 8000.0)
    pipe = ShardedPipeline(mesh, RATE, filt=FilterDesign.from_sos(sos),
                           env=None, spectrogram=False)
    x = signal[:64, :1]  # far shorter than the FIR kernel
    out = pipe(x)
    want = sps.sosfilt(sos, x.astype(np.float64), axis=0)
    np.testing.assert_allclose(np.asarray(out["filtered"])[:64], want,
                               atol=2e-5)


def test_channel_count_pads_to_mesh(signal):
    """Odd channel counts pad to the ch mesh axis internally and trim
    back — a 3-channel recording must not raise a raw divisibility
    error."""
    mesh = make_mesh(seq=4, ch=2)
    sos = design_filter(RATE, 2000.0, 8000.0)
    x3 = np.concatenate([signal, signal[:, :1]], axis=1)  # 3 channels
    pipe = ShardedPipeline(mesh, RATE, filt=FilterDesign.from_sos(sos),
                           env=None, spectrogram=False)
    out = pipe(x3)
    assert out["filtered"].shape[1] == 3
    want = sps.sosfilt(sos, x3.astype(np.float64), axis=0)
    np.testing.assert_allclose(np.asarray(out["filtered"])[: len(x3)],
                               want, atol=2e-5)


def test_sharded_minmax_ragged_tail_matches_interactive(signal):
    """The global zero padding must not leak into the overview's final
    partial bin (the interactive minmax pads ragged tails neutrally)."""
    from audian_tpu.ops.minmax import minmax_interleaved

    mesh = make_mesh(seq=8, ch=1)
    pipe = ShardedPipeline(mesh, RATE, filt=None, env=None,
                           spectrogram=False, minmax_step=512)
    n = 8 * 4096 + 100
    x = (0.5 + 0.5 * np.abs(signal[:n, :1]))  # strictly positive
    out = pipe(x)
    want = np.asarray(minmax_interleaved(jnp.asarray(x), 512))
    got = np.asarray(out["minmax"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got.min() > 0.0  # no spurious zero bin from the padding


def test_halo_exchange_contract_error():
    mesh = make_mesh(seq=8, ch=1)
    from jax import shard_map

    def local(x):
        return halo_exchange(x, 64, 0, "seq")

    f = shard_map(local, mesh=mesh, in_specs=P("seq", None),
                  out_specs=P("seq", None))
    with pytest.raises(ValueError, match="halo"):
        f(jnp.zeros((8 * 16, 1)))  # per-shard L=16 < before=64


def test_sharded_pipeline_int16_matches_float(signal):
    """int16 (raw PCM-16) recordings run the sharded chain with int16
    halo exchange over the ring and shard-local dequantization — the
    outputs equal feeding the dequantized float32 stream exactly."""
    mesh = make_mesh(seq=4, ch=2)
    filt = FilterDesign.from_sos(design_filter(RATE, 1000.0, 8000.0))
    env = FilterDesign.from_sos(design_envelope_filter(RATE, 500.0))
    pipe = ShardedPipeline(mesh, RATE, filt=filt, env=env, nfft=256,
                           minmax_step=500)  # ragged tail: n % 500 != 0
    q = np.clip(np.round(np.asarray(signal) * 32768.0),
                -32768, 32767).astype(np.int16)
    xq = q.astype(np.float32) / 32768.0
    out_q = pipe(q)
    out_f = pipe(xq)
    assert set(out_q) == set(out_f)
    for k in out_f:
        np.testing.assert_array_equal(np.asarray(out_q[k]),
                                      np.asarray(out_f[k]))


def test_mesh_backed_interactive_session(tmp_path, rng):
    """Data(..., mesh=...) channel-shards the interactive session's
    device windows across the mesh (XLA propagates the sharding through
    every derived-window and render-tile program, no collectives) and
    every read/tile matches the single-device session — the interactive
    analog of BASELINE config 3."""
    from audian_tpu.app import DataBrowser
    from audian_tpu.data import wavio

    rate = 8000.0
    t = np.arange(int(12.0 * rate)) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (300 + 100 * c) * t)
                  + 0.02 * rng.standard_normal(len(t))
                  for c in range(8)], axis=1)
    p = tmp_path / "mesh.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    mesh = make_mesh(seq=1, ch=8)
    bm = DataBrowser(str(p), mesh=mesh)
    b1 = DataBrowser(str(p))
    try:
        bm.open()
        b1.open()
        for t0 in (2.0, 5.0):  # open view + a sliding scroll
            bm.set_times(t0, 3.0)
            b1.set_times(t0, 3.0)
            buf = bm.data["filtered"].buffer
            assert len(buf.sharding.device_set) == 8
            i0, i1 = int((t0 + 0.5) * rate), int((t0 + 1.5) * rate)
            for name in ("data", "filtered"):
                np.testing.assert_allclose(
                    np.asarray(bm.data[name][i0:i1]),
                    np.asarray(b1.data[name][i0:i1]), atol=1e-5)
            _ta, va = bm.trace_tile("filtered", 5)
            _tb, vb = b1.trace_tile("filtered", 5)
            np.testing.assert_allclose(va, vb, atol=1e-4)
            ia, ra = bm.spec_tile(5, quantize=True)
            ib, rb = b1.spec_tile(5, quantize=True)
            assert ra == rb
            assert np.abs(ia.astype(int) - ib.astype(int)).max() <= 1
    finally:
        bm.close()
        b1.close()


def test_mesh_odd_channels_fall_back_replicated(tmp_path, rng):
    """Channel counts that do not divide the mesh axis stay replicated
    (sessions must open, not raise)."""
    from audian_tpu.app import DataBrowser
    from audian_tpu.data import wavio

    rate = 8000.0
    x = 0.1 * rng.standard_normal((int(6.0 * rate), 3))  # 3 % 8 != 0
    p = tmp_path / "odd.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    b = DataBrowser(str(p), mesh=make_mesh(seq=1, ch=8))
    try:
        b.open()
        b.set_times(1.0, 2.0)
        assert len(np.asarray(b.data["filtered"][100:200])) == 100
    finally:
        b.close()


def test_mesh_backed_session_scrubs_match(tmp_path, rng):
    """Parameter scrubs (filter cutoffs, NFFT) on a mesh-backed session
    recompute sharded and still match the single-device session."""
    from audian_tpu.app import DataBrowser
    from audian_tpu.data import wavio

    rate = 8000.0
    t = np.arange(int(10.0 * rate)) / rate
    x = np.stack([0.3 * np.sin(2 * np.pi * (400 + 150 * c) * t)
                  + 0.02 * rng.standard_normal(len(t))
                  for c in range(4)], axis=1)
    p = tmp_path / "scrub.wav"
    wavio.write_audio(p, x, rate, encoding="PCM_16")
    bm = DataBrowser(str(p), mesh=make_mesh(devices=jax.devices()[:4],
                                            seq=1, ch=4))
    b1 = DataBrowser(str(p))
    try:
        bm.open()
        b1.open()
        for b in (bm, b1):
            b.set_times(2.0, 3.0)
            b.update_filter(highpass_cutoff=300.0, lowpass_cutoff=2500.0)
            b.set_resolution(nfft=512)
        assert len(bm.data["filtered"].buffer.sharding.device_set) == 4
        i0, i1 = int(3.0 * rate), int(4.0 * rate)
        np.testing.assert_allclose(
            np.asarray(bm.data["filtered"][i0:i1]),
            np.asarray(b1.data["filtered"][i0:i1]), atol=1e-5)
        sm = np.asarray(bm.data[bm.spectrogram][100:140])
        s1 = np.asarray(b1.data[b1.spectrogram][100:140])
        np.testing.assert_allclose(sm, s1, rtol=1e-5, atol=1e-12)
    finally:
        bm.close()
        b1.close()
