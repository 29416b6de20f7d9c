"""Batch / multi-chip processing examples.

Three ways to process whole recordings without the interactive browser:

1. the fused single-chip batch chain (`FusedChainCF`) — what `bench.py`
   times;
2. the mesh-sharded pipeline (`ShardedPipeline`) — time axis sharded
   across devices with halo exchange between neighbours;
3. file-level data parallelism (`parallel.map_files`) over a directory,
   one recording per chip, composing with the song-detection pipeline.

Run on any backend; on a CPU-only host, force a virtual mesh first:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/batch_pipeline.py
"""

import sys

import numpy as np
import jax

import audian_tpu

audian_tpu.enable_compilation_cache()

from audian_tpu.ops import (FilterDesign, design_filter,
                            design_envelope_filter)
from audian_tpu.ops.fused import FusedChainCF
from audian_tpu.parallel import make_mesh, ShardedPipeline, map_files
from audian_tpu.analysis.events import detect

RATE = 48000.0


def make_recording(seconds=30.0, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * RATE)
    t = np.arange(n) / RATE
    x = 0.02 * rng.standard_normal((n, channels)).astype(np.float32)
    burst = (t % 10.0) < 1.2
    x += (0.5 * burst * np.sin(2 * np.pi * 6500.0 * t))[:, None].astype(
        np.float32)
    return x


def fused_single_chip(x):
    """One device program: filter -> {envelope, spectrogram PSD}."""
    fused = FusedChainCF(
        RATE,
        filt_sos=design_filter(RATE, 2000.0, 10000.0),
        env_sos=design_envelope_filter(RATE, 500.0),
        nfft=256, hop=128,
    )
    chunk = 1 << 20
    ext = np.zeros((x.shape[1], fused.hb + chunk + fused.ha), np.float32)
    n = min(chunk, len(x))
    ext[:, fused.hb : fused.hb + n] = x[:n].T
    y, env, psd, stats = fused.chain_cf(ext, chunk, stats=True)
    print(f"fused chain: filtered {y.shape}, envelope {env.shape}, "
          f"PSD {psd.shape}, per-channel power {np.asarray(stats['power'])}")


def sharded_whole_recording(x):
    """Time-sharded whole-recording run over every available device."""
    ndev = len(jax.devices())
    seq = max(1, ndev // 2 * 2) if ndev > 1 else 1
    mesh = make_mesh(seq=seq, ch=1)
    pipe = ShardedPipeline(
        mesh, RATE,
        filt=FilterDesign.from_sos(design_filter(RATE, 2000.0, 10000.0)),
        env=FilterDesign.from_sos(design_envelope_filter(RATE, 500.0)),
        minmax_step=512,
    )
    out = pipe(x)
    print(f"sharded over {seq} chips: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in out.items()))


def detect_directory(paths):
    """One recording per chip; host-side event logic overlaps device DSP."""
    def process(path):
        from audian_tpu.data import wavio

        data, rate = wavio.load_audio(path)
        r = detect(data, rate, highpassfreq=5500.0, lowpassfreq=7500.0,
                   envelopecutofffreq=100.0, minduration=0.5,
                   return_filtered=False)
        return path, [list(np.round(o, 2)) for o in r["onsets"]]

    for path, onsets in map_files(process, paths):
        print(f"{path}: onsets {onsets}")


if __name__ == "__main__":
    x = make_recording()
    fused_single_chip(x)
    sharded_whole_recording(x)
    if len(sys.argv) > 1:
        detect_directory(sys.argv[1:])
