"""Randomized configuration fuzzing of the sharded pipeline.

`tests/test_parallel.py` pins sharded == whole for two hand-picked mesh
splits of the default geometry.  This fuzzer samples random
(seq × ch) meshes, rates, channel counts, recording lengths, cutoffs,
and spectrogram/minmax geometries, and asserts every output of
:class:`ShardedPipeline` against scipy float64 oracles — the
halo-exchange analog of the DAG-shape fuzzer.  Configs whose halo
exceeds the per-shard length are expected to raise the documented loud
error and are skipped.
"""

import numpy as np
import pytest
import scipy.signal as sps

import jax

from audian_tpu.ops import (FilterDesign, design_filter,
                            design_envelope_filter)
from audian_tpu.parallel import make_mesh, ShardedPipeline


def _random_config(r):
    seq, ch = [(8, 1), (4, 2), (2, 4), (4, 1), (2, 2), (1, 8)][
        int(r.integers(0, 6))]
    rate = float(r.choice([16000.0, 48000.0]))
    channels = int(r.integers(1, 5))
    seconds = float(r.uniform(1.5, 3.0))
    nfft = int(r.choice([128, 256, 512]))
    hop = int(r.choice([nfft // 4, nfft // 2, nfft]))
    minmax_step = int(r.choice([0, 256, 512])) or None
    with_filter = r.random() < 0.8
    hp = float(r.uniform(0.01, 0.1)) * rate if r.random() < 0.7 else 0.0
    lp = float(r.uniform(0.2, 0.45)) * rate
    env_cutoff = float(r.uniform(0.02, 0.08)) * rate
    with_env = r.random() < 0.8
    return dict(seq=seq, ch=ch, rate=rate, channels=channels,
                seconds=seconds, nfft=nfft, hop=hop,
                minmax_step=minmax_step, with_filter=with_filter,
                hp=hp, lp=lp, env_cutoff=env_cutoff, with_env=with_env)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sharded_pipeline_random_configs(rng, seed):
    r = np.random.default_rng(3000 + seed)
    cfg = _random_config(r)
    rate = cfg["rate"]
    n = int(cfg["seconds"] * rate)
    t = np.arange(n) / rate
    am = (np.sin(2 * np.pi * 3.0 * t) > 0).astype(float)
    x = np.stack([0.5 * np.sin(2 * np.pi * (0.1 + 0.02 * c) * rate * t)
                  * am + 0.02 * rng.standard_normal(n)
                  for c in range(cfg["channels"])], axis=1).astype(
                      np.float32)

    devices = jax.devices()[: cfg["seq"] * cfg["ch"]]
    mesh = make_mesh(devices=devices, seq=cfg["seq"], ch=cfg["ch"])
    filt = (FilterDesign.from_sos(design_filter(rate, cfg["hp"], cfg["lp"]))
            if cfg["with_filter"] else None)
    env = (FilterDesign.from_sos(design_envelope_filter(
        rate, cfg["env_cutoff"])) if cfg["with_env"] else None)

    pipe = ShardedPipeline(mesh, rate, filt=filt, env=env,
                           nfft=cfg["nfft"], hop=cfg["hop"],
                           minmax_step=cfg["minmax_step"])
    try:
        out = pipe(x)
    except ValueError as exc:
        assert "halo" in str(exc).lower(), \
            f"seed {seed} cfg {cfg}: unexpected error {exc!r}"
        pytest.skip(f"halo exceeds shard for cfg {cfg} (documented)")

    x64 = x.astype(np.float64)
    want_f = (sps.sosfilt(filt.sos, x64, axis=0) if filt is not None
              else x64)
    got_f = np.asarray(out["filtered"])[:n]
    np.testing.assert_allclose(got_f, want_f, atol=1e-5,
                               err_msg=f"seed {seed} cfg {cfg}: filtered")

    if env is not None:
        want_e = sps.sosfiltfilt(env.sos, (np.pi / 2) * np.abs(want_f),
                                 axis=0)
        want_e[want_e < 0] = 0
        got_e = np.asarray(out["envelope"])[:n]
        # documented bounded artifact at the global recording ends
        edge = 2 * (env.fir.length + env.padlen)
        if n > 3 * edge:
            np.testing.assert_allclose(
                got_e[edge:-edge], want_e[edge:-edge], atol=1e-5,
                err_msg=f"seed {seed} cfg {cfg}: envelope")
        assert np.all(np.isfinite(got_e))

    _, _, want_s = sps.spectrogram(
        want_f, fs=rate, window="hann", nperseg=cfg["nfft"],
        noverlap=cfg["nfft"] - cfg["hop"], detrend=False,
        scaling="density", mode="psd", axis=0)
    got_s = np.asarray(out["spectrogram"])
    nf = want_s.shape[2]
    np.testing.assert_allclose(
        got_s[:nf], want_s.transpose(2, 1, 0), rtol=1e-4, atol=1e-9,
        err_msg=f"seed {seed} cfg {cfg}: spectrogram")

    if cfg["minmax_step"]:
        mm = np.asarray(out["minmax"])
        step = cfg["minmax_step"]
        # the minmax output is trimmed to real (non-padding) bins
        assert mm.shape[0] == 2 * int(np.ceil(n / step))
        # the overview pyramid decimates the RAW stream (reference
        # fulltrace parity), not the filtered one
        np.testing.assert_allclose(mm[0, 0], x[:step, 0].min(), atol=1e-6)
        np.testing.assert_allclose(mm[1, 0], x[:step, 0].max(), atol=1e-6)
