"""Smoke run of audian-tpu's main paths on one GPU (or four).

Drives the program through the entry points a user calls, at the sizes
users run, and checks every output against the scipy float64 oracles:

- the batch chain (``FusedChainCF.chain_cf``) over one hour of 16-channel
  96 kHz int16 audio, timed, one whole chunk checked;
- ``audian-songdetector`` on a synthesized 16-channel WAV, its decimated
  envelope checked on three interior windows;
- an interactive ``DataBrowser`` session over the same file (scroll,
  cutoff scrub without recompiling, trace and spectrogram tiles);
- ``audian-compress`` on the same file;
- the ``gpu``-marked device tests.

Every dot runs at ``Precision.HIGHEST`` (on a GPU a float32 dot without
a precision may run in TF32, which would break the 1e-5 contract).

Usage::

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards

The parent process stays off JAX; each phase group runs in one child
process at a time, so only one process holds the card.  Without a GPU
the run fails and prints no result.  The last line of stdout is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

RATE = 96000.0
CHANNELS = 16


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _psd_db_error(got, ref):
    """Largest dB difference over bins within 60 dB of the peak."""
    import numpy as np

    mask = ref > ref.max() * 1e-6
    return float(np.abs(10 * np.log10(np.maximum(got, 1e-30))
                        - 10 * np.log10(np.maximum(ref, 1e-30)))[mask].max())


#: songs of the detector recording: SONG_LEN s bursts starting SONG_START
#: s into every SONG_PERIOD s
SONG_PERIOD, SONG_START, SONG_LEN = 8.0, 3.0, 1.5


def _synth_int16(frames, channels, seed, start=0, rate=RATE):
    """Song-like bursts (6.5 kHz carrier, 1 s on/off) plus noise, PCM-16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = (np.arange(frames) + start) / rate
    tone = 0.4 * np.sin(2 * np.pi * 6500.0 * t) * (
        np.sin(2 * np.pi * 0.5 * t) > 0)
    x = tone[:, None] + 0.05 * rng.standard_normal((frames, channels))
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)


# -- phases -------------------------------------------------------------------


def phase_batch_chain(seconds=3600.0, channels=CHANNELS, chunk=1 << 22,
                      rate=RATE):
    """The batch chain over ``seconds`` of audio in device-resident int16
    chunks, as ``bench.py`` times it; one whole chunk is checked against
    scipy float64: filtered and envelope within 1e-5 absolute, PSD
    within 0.05 dB for bins within 60 dB of the peak.  Returns the wall
    time and the errors."""
    import numpy as np
    import scipy.signal as sps
    import jax
    import jax.numpy as jnp

    from audian_tpu.models import get_preset
    from audian_tpu.ops import design_filter, design_envelope_filter

    preset = get_preset("bioacoustics")
    fused = preset.fused(rate, eps=2e-6)
    ext = fused.hb + chunk + fused.ha
    nchunks = -(-int(seconds * rate) // chunk)

    @jax.jit
    def make_chunk(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        t = (jnp.arange(ext, dtype=jnp.float32) / rate)[None, :]
        tone = jnp.sin(2 * jnp.pi * 30000.0 * t) * (
            jnp.sin(2 * jnp.pi * 5.0 * t) > 0)
        x = 0.5 * tone + 0.05 * jax.random.normal(key, (channels, ext))
        return jnp.clip(jnp.round(x * 32768.0), -32768, 32767
                        ).astype(jnp.int16)

    @jax.jit
    def chain(x_ext):
        _y, _e, _s, st = fused.chain_cf(x_ext, chunk, stats=True)
        return st

    chunks = jax.block_until_ready([make_chunk(i) for i in range(4)])
    jax.block_until_ready(chain(chunks[0]))
    t0 = time.perf_counter()
    outs = [chain(chunks[i % len(chunks)]) for i in range(nchunks)]
    jax.block_until_ready(outs)
    wall = time.perf_counter() - t0

    y, e, s = (np.asarray(a) for a in fused.chain_cf(chunks[0], chunk))
    x64 = np.asarray(chunks[0]).astype(np.float64) / 32768.0
    sos_f = np.asarray(design_filter(rate, preset.highpass_cutoff,
                                     preset.lowpass_cutoff,
                                     preset.filter_order), np.float64)
    sos_e = np.asarray(design_envelope_filter(rate, preset.envelope_cutoff),
                       np.float64)
    y64 = sps.sosfilt(sos_f, x64, axis=1)
    e64 = np.maximum(sps.sosfiltfilt(sos_e, (np.pi / 2) * np.abs(y64),
                                     axis=1, padtype=None), 0.0)
    y64 = y64[:, fused.hb : fused.hb + chunk]
    e64 = e64[:, fused.hb : fused.hb + chunk]
    _f, _t, S = sps.spectrogram(
        y64, fs=rate, window="hann", nperseg=fused.nfft,
        noverlap=fused.nfft - fused.hop, detrend=False, mode="psd", axis=1)
    ref = S.transpose(2, 0, 1)[: s.shape[0]]
    res = {"wall_s": wall, "nchunks": nchunks,
           "filtered_err": float(np.max(np.abs(y - y64))),
           "envelope_err": float(np.max(np.abs(e - e64))),
           "psd_db_err": _psd_db_error(s[: ref.shape[0]], ref)}
    assert y.shape == e.shape == (channels, chunk)
    assert res["filtered_err"] < 1e-5, res
    assert res["envelope_err"] < 1e-5, res
    assert res["psd_db_err"] < 0.05, res
    return res


def write_recording(path, seconds, channels=CHANNELS, rate=RATE, seed=0):
    """Synthesize a PCM-16 WAV of sparse songs from ``seed`` (6.5 kHz
    carrier with a 30 Hz pulse rhythm, see ``SONG_*``) plus noise;
    returns its int16 samples."""
    import numpy as np

    from audian_tpu.data import wavio

    frames = int(seconds * rate)
    t = np.arange(frames) / rate
    phase = t % SONG_PERIOD
    song = (phase >= SONG_START) & (phase < SONG_START + SONG_LEN)
    x = (0.4 * np.sin(2 * np.pi * 6500.0 * t) * song
         * 0.5 * (1 + np.sin(2 * np.pi * 30.0 * t)))
    rng = np.random.default_rng(seed)
    x = x[:, None] + 0.05 * rng.standard_normal((frames, channels))
    q = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    wavio.write_audio(path, q.astype("float64") / 32768.0, rate,
                      encoding="PCM_16")
    return q


def phase_song_detector(wav, q, rate=RATE):
    """``audian-songdetector`` through ``cli/songdetector.main``: every
    synthesized song is found in every channel within 50 ms, and the
    decimated envelope is checked against ``events.detect_env_oracle``
    on three interior windows at 2e-5 relative (with context, so the
    window edges see the whole recording)."""
    import numpy as np

    from audian_tpu.analysis import events
    from audian_tpu.cli import songdetector

    band_env, make_envdet = events.band_env, events._make_envdet
    detect = songdetector.detect
    seen = {}

    def spy_detect(*a, **k):
        seen["detect"] = out = detect(*a, **k)
        return out

    def spy_band_env(*a, **k):
        out = band_env(*a, **k)
        # copy: detect() refines the envelope in place afterwards
        seen["band_env"] = (out[0], out[1].copy(), out[2])
        return out

    def spy_make_envdet(*a, **k):
        seen["envdet"] = out = make_envdet(*a, **k)
        return out

    csv = Path(wav).with_suffix(".songs.csv")
    events.band_env, events._make_envdet = spy_band_env, spy_make_envdet
    songdetector.detect = spy_detect
    try:
        rc = songdetector.main([str(wav), "-o", str(csv)])
    finally:
        events.band_env, events._make_envdet = band_env, make_envdet
        songdetector.detect = detect
    assert rc == 0 and csv.exists()
    assert seen.get("envdet") is not None, "fused detect path not taken"
    n = len(q)
    starts = np.arange(SONG_START, n / rate - SONG_LEN, SONG_PERIOD)
    for ons, offs in zip(seen["detect"]["onsets"], seen["detect"]["offsets"]):
        assert len(ons) == len(starts), (ons, starts)
        assert np.allclose(ons, starts, atol=0.05), (ons, starts)
        assert np.allclose(offs, starts + SONG_LEN, atol=0.05), offs
    _f, env, envrate = seen["band_env"]
    step = int(round(rate / envrate))
    fd = events.FilterDesign.from_sos(events.sps.butter(
        1, (1000.0, 10000.0), "bandpass", fs=rate, output="sos"))
    ed = events.FilterDesign.from_sos(events.sps.butter(
        1, 500.0, "lowpass", fs=rate, output="sos"))
    ctx = (events._CHUNK // 16 // step) * step
    wlen = (events._CHUNK // 8 // step) * step
    errs = []
    for wstart in (events._CHUNK - wlen // 2, n // 2,
                   2 * events._CHUNK - wlen // 2):
        a = (wstart // step) * step
        lo = a - ctx
        assert lo >= 0 and a + wlen + ctx <= n
        x64 = q[lo : a + wlen + ctx].astype(np.float64) / 32768.0
        _y, ref = events.detect_env_oracle(x64, step, fd, ed)
        npts = wlen // step
        got = np.asarray(env[a // step : a // step + npts])
        ref = ref[ctx // step : ctx // step + npts]
        errs.append(float(np.max(np.abs(got - ref)))
                    / max(float(np.max(np.abs(ref))), 1e-9))
    assert max(errs) < 2e-5, errs
    return {"envelope_rel_err": max(errs), "songs_per_channel": len(starts)}


def phase_browser(wav, q, rate=RATE):
    """An interactive session: open, scroll, scrub the cutoff (no
    recompile), pull trace and spectrogram tiles; the visible windows
    match scipy float64 at 1e-5 and the host fallback never engages."""
    import numpy as np
    import scipy.signal as sps

    from audian_tpu.app import DataBrowser
    from audian_tpu.ops import design_filter
    from audian_tpu.utils.devicewatch import watch

    b = DataBrowser(str(wav)).open()
    host_calls = []
    host_windows = b.data._host_windows

    def spy_host_windows(*a, **k):
        host_calls.append(a)
        return host_windows(*a, **k)

    b.data._host_windows = spy_host_windows
    try:
        def render():
            for c in b.show_channels:
                b.trace_tile("filtered", c)
            for c in b.show_channels:
                b.spec_tile(c, quantize=True)

        hp = 2000.0
        b.update_filter(highpass_cutoff=hp, lowpass_cutoff=18000.0)
        b.set_times(1.0, 2.0)
        render()
        for k in range(6):
            b.time_page_down() if k < 4 else b.time_page_up()
            render()
        ncomp = b.data.executor.cache_size
        for lp in (25000.0, 22000.0, 20000.0):
            b.update_filter(highpass_cutoff=hp, lowpass_cutoff=lp)
            render()
        assert b.data.executor.cache_size == ncomp, "cutoff scrub recompiled"
        i0 = int((b.toffset + 0.25) * rate)
        i1 = i0 + int(rate)
        x64 = q.astype(np.float64) / 32768.0
        want = sps.sosfilt(np.asarray(design_filter(rate, hp, lp),
                                      np.float64), x64, axis=0)[i0:i1]
        got = np.asarray(b.data["filtered"][i0:i1])
        raw = np.asarray(b.data["data"][i0:i1])
        res = {"filtered_err": float(np.max(np.abs(got - want))),
               "data_err": float(np.max(np.abs(raw - x64[i0:i1])))}
        assert got.shape == want.shape
        assert res["filtered_err"] < 1e-5 and res["data_err"] < 1e-5, res
        assert not watch.lost and not host_calls, "host mode engaged"
    finally:
        b.close()
    return res


def phase_compress(wav, q):
    """``audian-compress``: the min/max overview artifact next to the
    file equals numpy's per-segment extrema."""
    import numpy as np

    from audian_tpu.cli import compress
    from audian_tpu.data import wavio

    assert compress.main([str(wav)]) == 0
    art = Path(wav).with_name(Path(wav).stem + "-fulltrace.wav")
    datas, _rate = wavio.load_audio(art)
    step = max(1, len(q) // 6000)
    whole = len(q) // step
    body = (q[: whole * step].astype(np.float64) / 32768.0).reshape(
        whole, step, q.shape[1])
    assert np.allclose(datas[0 : 2 * whole : 2], body.min(axis=1))
    assert np.allclose(datas[1 : 2 * whole : 2], body.max(axis=1))
    return {"overview_rows": int(datas.shape[0])}


def phase_sharded_pipeline(devices, frames=1 << 24, channels=CHANNELS,
                           rate=RATE):
    """``ShardedPipeline`` with ``seq=len(devices)`` against the same
    pipeline on one device, at 1e-5."""
    import numpy as np
    import jax

    from audian_tpu.models import get_preset
    from audian_tpu.parallel import make_mesh

    preset = get_preset("bioacoustics")
    mesh = make_mesh(devices=devices, seq=len(devices), ch=1)
    pipe = preset.sharded(mesh, rate, eps=2e-6)
    n = pipe.padded_length(frames)
    x = _synth_int16(n, channels, seed=1, rate=rate).astype(np.float32)
    x /= 32768.0
    out = jax.block_until_ready(pipe(x))
    ref_pipe = preset.sharded(make_mesh(devices=devices[:1], seq=1, ch=1),
                              rate, eps=2e-6)
    ref = jax.block_until_ready(ref_pipe(x))
    errs = {}
    for key in out:
        a, b = np.asarray(out[key]), np.asarray(ref[key])
        assert a.shape == b.shape, key
        scale = max(float(np.max(np.abs(b))), 1e-30)
        errs[key] = float(np.max(np.abs(a - b))) / (
            scale if key == "spectrogram" else 1.0)
        assert errs[key] < 1e-5, (key, errs[key])
    return errs


def phase_sharded_detect(devices, channels=CHANNELS, rate=RATE):
    """``events.band_env(..., mesh=)`` over a ``seq`` mesh covering at
    least four chunks, against the single-device chunked driver."""
    import numpy as np

    from audian_tpu.analysis import events
    from audian_tpu.parallel import make_mesh

    n = 4 * events._CHUNK + 999
    q = _synth_int16(n, channels, seed=2, rate=rate)
    mesh = make_mesh(devices=devices, seq=len(devices), ch=1)
    _f, ref, er = events.band_env(q, rate, 1000.0, 10000.0, 500.0,
                                  return_filtered=False)
    _f, got, er2 = events.band_env(q, rate, 1000.0, 10000.0, 500.0,
                                   return_filtered=False, mesh=mesh)
    assert er == er2 and got.shape == ref.shape
    err = float(np.max(np.abs(got - ref))) / float(np.max(np.abs(ref)))
    assert err < 1e-5, err
    return {"envelope_rel_err": err}


# -- process orchestration -----------------------------------------------------


def _device_info():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _report(name, res):
    print(f"[smoke] {name}: {json.dumps(res)}", flush=True)


def child_main(result_file):
    """One-card phases in this (the only JAX) process."""
    info = _device_info()
    import audian_tpu

    audian_tpu.enable_compilation_cache()
    card = card_line()
    res = phase_batch_chain()
    _report("batch chain", res)
    print(f"[smoke] batch chain 1 h x {CHANNELS} ch x 96 kHz wall "
          f"{res['wall_s']:.4f} s on {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "smoke16.wav"
        q = write_recording(wav, 64.0)
        _report("song detector", phase_song_detector(wav, q))
        _report("browser", phase_browser(wav, q))
        _report("compress", phase_compress(wav, q))
    Path(result_file).write_text(json.dumps(info))


def child_four(result_file):
    """The four-card phases and their one-card references."""
    info = _device_info()
    if info["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found {info['count']}")
    import jax

    import audian_tpu
    import __graft_entry__

    audian_tpu.enable_compilation_cache()
    devices = jax.devices()[:4]
    _report("sharded pipeline", phase_sharded_pipeline(devices))
    _report("sharded detect", phase_sharded_detect(devices))
    __graft_entry__.mesh_browser_phase(devices)
    _report("mesh browser", {"ok": True})
    Path(result_file).write_text(json.dumps(info))


def run_device_tests():
    """The gpu-marked tests in a child process; all must run and pass."""
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        xml = Path(tmp) / "junit.xml"
        env = dict(os.environ, AUDIAN_DEVICE_TESTS="1")
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={xml}",
             "tests/test_device_gpu.py"], cwd=REPO, env=env).returncode
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        counts = {k: int(suite.get(k)) for k in
                  ("tests", "errors", "failures", "skipped")}
    _report("device tests", counts)
    if rc or counts["tests"] == 0 or counts["skipped"] or \
            counts["errors"] or counts["failures"]:
        raise SystemExit(f"device tests failed (rc {rc}): {counts}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded paths on four cards")
    p.add_argument("--child", choices=("one", "four"), help=argparse.SUPPRESS)
    p.add_argument("--result", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        sys.path.insert(0, str(REPO))
        (child_main if args.child == "one" else child_four)(args.result)
        return 0

    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        result = Path(tmp) / "device.json"
        child = "four" if args.four_cards else "one"
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--child", child, "--result", str(result)],
                       cwd=REPO, check=True)
        device = json.loads(result.read_text())
    if not args.four_cards:
        run_device_tests()
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
