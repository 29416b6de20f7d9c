"""chip_smoke.py: it refuses to run without a GPU, and each of its phase
functions passes at a tiny size on the CPU mesh."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_fails_without_gpu():
    """The whole script: no card here, so it exits non-zero and prints
    no result line."""
    p = _run(["chip_smoke.py"], REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_smoke_child_refuses_cpu(tmp_path):
    """The device check itself: JAX finds only the CPU, so the phase
    process exits non-zero before any phase and writes no result."""
    result = tmp_path / "device.json"
    p = _run(["chip_smoke.py", "--child", "one", "--result", str(result)],
             REPO)
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert not result.exists()


def test_smoke_fails_outside_the_repo(tmp_path):
    """Copied alone into an empty directory, the script fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    result = tmp_path / "device.json"
    p = _run(["chip_smoke.py", "--child", "one", "--result", str(result)],
             tmp_path)
    assert p.returncode != 0
    assert not result.exists()


def test_phase_batch_chain_tiny(smoke):
    res = smoke.phase_batch_chain(seconds=0.5, channels=2, chunk=1 << 13)
    assert res["nchunks"] == 6
    assert res["wall_s"] > 0
    json.dumps(res)


@pytest.fixture
def recording(smoke, tmp_path, monkeypatch):
    """A short 2-channel recording; the detect chunk shrinks so that the
    recording still has an interior chunk on the fused path."""
    from audian_tpu.analysis import events

    monkeypatch.setattr(events, "_CHUNK", 1 << 15)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    wav = tmp_path / "rec.wav"
    q = smoke.write_recording(wav, 6.0, channels=2)
    return wav, q


def test_phase_song_detector_tiny(smoke, recording):
    res = smoke.phase_song_detector(*recording)
    assert res["envelope_rel_err"] < 2e-5
    assert res["songs_per_channel"] == 1


def test_phase_browser_tiny(smoke, recording):
    res = smoke.phase_browser(*recording)
    assert res["filtered_err"] < 1e-5


def test_phase_compress_tiny(smoke, recording):
    assert smoke.phase_compress(*recording)["overview_rows"] > 0


def test_phase_sharded_pipeline_four_devices(smoke):
    import jax

    errs = smoke.phase_sharded_pipeline(jax.devices()[:4], frames=1 << 14,
                                        channels=2)
    assert {"filtered", "envelope", "spectrogram"} <= set(errs)


def test_phase_sharded_detect_four_devices(smoke, monkeypatch):
    import jax

    from audian_tpu.analysis import events

    monkeypatch.setattr(events, "_CHUNK", 1 << 13)
    monkeypatch.setattr(events, "_KERNEL_BUDGET", {"filt": 0, "env": 0})
    res = smoke.phase_sharded_detect(jax.devices()[:4], channels=2)
    assert np.isfinite(res["envelope_rel_err"])
