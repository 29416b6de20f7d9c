"""bench.py machinery smoke tests (tiny shapes, CPU mesh).

`python bench.py` runs on the accelerator; these tests execute the io
pipeline and the stress leg's oracle machinery at toy sizes, so bitrot
(an API drift in the io loop, a broken component field, a stress-leg
assert) shows up before a benchmark run.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest


@pytest.fixture(scope="module")
def bench():
    sys.path.insert(0, str(Path(__file__).parents[1]))
    mod = importlib.import_module("bench")
    return mod


def test_bench_io_components(bench, tmp_path, rng, monkeypatch):
    """bench_io runs end-to-end on tiny files and reports a complete,
    consistent component breakdown."""
    monkeypatch.setattr(bench, "IO_CHUNK", 1 << 14)
    rate = bench.RATE
    files = []
    from audian_tpu.data import wavio

    frames = (1 << 15) + 4096
    for i in range(2):
        x = (0.1 * rng.standard_normal((frames, 4))).astype(np.float32)
        f = tmp_path / f"io{i}.wav"
        wavio.write_audio(f, x, rate, encoding="PCM_16")
        files.append(f)
    fused = bench.build_chain()
    wall, audio_seconds, comps = bench.bench_io(fused, files)
    assert wall > 0
    nchunks = (2 * frames) // (1 << 14)
    assert audio_seconds == pytest.approx(nchunks * (1 << 14) / rate)
    for key in ("read_s", "upload_s", "dispatch_s", "open_s",
                "fence_s", "bytes_read"):
        assert key in comps, key
    assert comps["bytes_read"] == sum(f.stat().st_size for f in files)
    assert comps["read_s"] >= 0 and comps["fence_s"] >= 0
    # the components are JSON-serializable as emitted
    json.dumps(comps)


def test_bench_io_flac_recording(bench, tmp_path, monkeypatch):
    """_bench_recording('flac') produces decodable FLAC twins of the
    WAV corpus (8-channel ceiling enforced)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(bench, "IO_FILE_SECONDS", 0.25)
    assert bench._bench_recording("flac", channels=16) is None
    flacs = bench._bench_recording("flac", channels=2)
    if flacs is None:
        pytest.skip("no FLAC encoder available")
    wavs = bench._bench_recording("wav", channels=2)
    from audian_tpu.data import wavio

    for f, w in zip(flacs, wavs):
        fi = wavio.wav_info(f)
        wi = wavio.wav_info(w)
        assert fi[:3] == wi[:3]  # same rate/channels/frames
        a = wavio.read_frames(f, 100, 500)
        b = wavio.read_frames(w, 100, 500)
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_bench_stress_small(bench, monkeypatch):
    """The stress leg (detect over more than "device memory", oracle
    windows, compress artifact) runs at a toy memory size and prints a
    valid JSON line."""
    import io
    from contextlib import redirect_stdout

    out = io.StringIO()
    with redirect_stdout(out):
        bench.bench_stress(device_bytes=1 << 26)
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["unit"] == "Msamples/s" and rec["value"] > 0
    assert rec["components"]["oracle_windows_checked"] == 3


def test_bench_stress_components(bench, monkeypatch):
    """The stress leg attributes its wall: single-file corpus,
    read/upload/compute components present and plausible."""
    import io
    from contextlib import redirect_stdout

    out = io.StringIO()
    with redirect_stdout(out):
        bench.bench_stress(device_bytes=1 << 26)
    rec = json.loads([ln for ln in out.getvalue().splitlines()
                      if ln.startswith("{")][0])
    comps = rec["components"]
    for key in ("read_s", "read_MBps", "upload_s", "compute_s",
                "write_s", "detect_wall_s", "compress_wall_s"):
        assert key in comps, key
    assert comps["read_s"] > 0 and comps["read_MBps"] > 0
    # at toy size the whole recording fits one chunk and routes to the
    # host oracle (no device events); full-size runs report > 0
    assert comps["upload_s"] >= 0 and comps["compute_s"] >= 0
    assert "ONE RF64 file" in rec["metric"]


def test_bench_interactive_smoke(bench, tmp_path, monkeypatch):
    """bench_interactive drives a real browser session and reports every
    latency component."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(bench, "IO_FILE_SECONDS", 0.5)
    files = bench._bench_recording("wav", channels=2)
    rec = bench.bench_interactive(files)
    comps = rec["components"]
    for key in ("open_warm_s", "scroll_p50_ms", "scroll_p95_ms",
                "cutoff_scrub_s", "nfft_step_s", "autoscale_ms"):
        assert key in comps, key
    assert rec["value"] > 0 and rec["unit"] == "ms"
    json.dumps(rec)


def test_bench_io_throttle_paces_reads(bench, tmp_path, rng, monkeypatch):
    """throttle_mbps paces the reader to the emulated container-byte
    rate: the throttled wall is bounded below by bytes/rate."""
    monkeypatch.setattr(bench, "IO_CHUNK", 1 << 14)
    from audian_tpu.data import wavio

    rate = bench.RATE
    frames = 1 << 15
    files = []
    for i in range(2):
        x = (0.1 * rng.standard_normal((frames, 2))).astype(np.float32)
        f = tmp_path / f"th{i}.wav"
        wavio.write_audio(f, x, rate, encoding="PCM_16")
        files.append(f)
    fused = bench.build_chain()
    nbytes = sum(f.stat().st_size for f in files)
    mbps = 2.0
    wall, _sec, comps = bench.bench_io(fused, files, throttle_mbps=mbps)
    # the warm-up chunk is discounted; the paced span covers the rest
    expected_floor = (nbytes * (1 - (1 << 14) / (2 * frames))
                      / (mbps * 2**20))
    assert wall >= 0.8 * expected_floor, (wall, expected_floor)
