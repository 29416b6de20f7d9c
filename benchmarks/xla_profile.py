"""Time the plain-XLA batch programs on the card and split their device
time between matmul (GEMM) kernels and everything else.

    python benchmarks/xla_profile.py [--out DIR]

Runs at the ``bench.py`` shapes:

- the batch chain (``FusedChainCF.chain_cf``) over 1 h x 16 ch x 96 kHz
  in 2^22-frame int16 chunks, ending in ``block_until_ready``;
- the batch detect envelope (``events._make_envdet``, the fused
  decimating path) over the same hour in ``events._CHUNK`` windows;
- the Toeplitz block size of ``ops/sos._conv1d_same_causal`` at the
  interactive window shape (60 s x 8 ch x 96 kHz).

Each of the first two is traced once with ``jax.profiler``; the device
events are reduced to the share of device time spent outside the
matmul kernels.  Prints one JSON object and writes the top kernels to
``DIR/xla_profile.json``.  Needs a GPU.
"""

import argparse
import glob
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RATE = 96000.0
CHANNELS = 16
HOUR = int(3600 * RATE)

#: kernel names of matmuls and convolutions: cuBLAS/cuBLASLt
#: (sm80_xmma_gemm..., cutlass...), cuDNN (implicit_gemm, convolve,
#: fprop), and XLA's own generated GEMMs
_DOT = re.compile(r"gemm|xmma|cutlass|cublas|cudnn|convolve|fprop|matmul"
                  r"|dot", re.I)


def device_events(trace_dir):
    """(name, duration_ns) of every event on a GPU device plane."""
    from jax.profiler import ProfileData

    files = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    out = []
    for f in files:
        for plane in ProfileData.from_file(f).planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                # XLA op lines duplicate the kernel lines; keep kernels
                if "XLA Ops" in line.name or "XLA Modules" in line.name:
                    continue
                out.extend((e.name, e.duration_ns) for e in line.events)
    return out


def reduce_events(events, top=25):
    """Total device time, the share outside matmul kernels, and the
    largest kernels by total time."""
    tot = sum(d for _n, d in events)
    dot = sum(d for n, d in events if _DOT.search(n))
    by = {}
    for n, d in events:
        by[n] = by.get(n, 0) + d
    kernels = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": tot / 1e6,
            "dot_ms": dot / 1e6,
            "non_dot_share": (tot - dot) / tot if tot else None,
            "top": [(n[:120], d / 1e6) for n, d in kernels]}


def traced(fn, args_list, tmp):
    """Run ``fn`` over ``args_list`` under the profiler; reduced events."""
    with jax.profiler.trace(tmp):
        jax.block_until_ready([fn(*a) for a in args_list])
    return reduce_events(device_events(tmp))


def best_of(fn, args_list, reps=3):
    jax.block_until_ready(fn(*args_list[0]))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([fn(*a) for a in args_list])
        best = min(best, time.perf_counter() - t0)
    return best


def chain_phase(tmp):
    import bench

    fused = bench.build_chain()
    chunk = bench.CHUNK
    ext = fused.hb + chunk + fused.ha
    n = -(-HOUR // chunk)

    @jax.jit
    def make_chunk(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        x = 0.3 * jax.random.normal(key, (CHANNELS, ext))
        return jnp.round(x * 32768.0).astype(jnp.int16)

    chain = bench._stats_chain(fused, chunk)
    chunks = jax.block_until_ready([make_chunk(i) for i in range(4)])
    args = [(chunks[i % 4],) for i in range(n)]
    wall = best_of(chain, args)
    prof = traced(chain, args[:4], tmp)
    return {"wall_s": wall, "chunks": n, "profile_4_chunks": prof}


def detect_phase(tmp):
    import scipy.signal as sps

    from audian_tpu.analysis import events
    from audian_tpu.ops import FilterDesign

    fd = FilterDesign.from_sos(sps.butter(1, (1000.0, 10000.0), "bandpass",
                                          fs=RATE, output="sos"))
    ed = FilterDesign.from_sos(sps.butter(1, 500.0, "lowpass", fs=RATE,
                                          output="sos"))
    step = 19
    halo = events.detect_halo(fd, ed)
    W = events._CHUNK + 2 * halo
    envdet = events._make_envdet(fd, ed, step, halo)

    @jax.jit
    def make_chunk(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(2), seed)
        x = 0.3 * jax.random.normal(key, (W, CHANNELS))
        return jnp.round(x * 32768.0).astype(jnp.int16)

    @jax.jit
    def fused_fn(xw):
        return jnp.sum(envdet(xw, halo))

    @jax.jit
    def unfused_fn(xw):
        _y, env = events._band_env_device(fd, ed, xw)
        return jnp.sum(events._strided_at(env, 0, step))

    chunks = jax.block_until_ready([make_chunk(i) for i in range(3)])
    n = -(-HOUR // events._CHUNK)
    args = [(chunks[i % 3],) for i in range(n)]
    return {"fused_wall_s": best_of(fused_fn, args),
            "unfused_wall_s": best_of(unfused_fn, args, reps=1),
            "chunks": n, "profile_3_chunks": traced(fused_fn, args[:3], tmp)}


def sos_block_phase():
    """``_conv1d_same_causal`` at the interactive window shape."""
    from audian_tpu.ops import design_filter, fir_kernels, sos

    h = jnp.asarray(fir_kernels(design_filter(RATE, 2000.0, 40000.0)).h,
                    jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(6), (int(60 * RATE), 8))
    out = {}
    for block in (128, 256, 512):
        fn = jax.jit(lambda v, blk=block: sos._conv1d_same_causal(
            v, h, block=blk))
        out[str(block)] = best_of(fn, [(x,)] * 8, reps=3) / 8 * 1e3
    out["picked"] = sos._pick_block(h.shape[0])
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out")
    args = p.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    import audian_tpu

    audian_tpu.enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    res = {"card": card, "device_kind": dev.device_kind}
    with tempfile.TemporaryDirectory() as t1, \
            tempfile.TemporaryDirectory() as t2:
        res["chain"] = chain_phase(t1)
        res["detect"] = detect_phase(t2)
    res["sos_block_ms"] = sos_block_phase()
    out = Path(args.out)
    out.mkdir(exist_ok=True)
    (out / "xla_profile.json").write_text(json.dumps(res, indent=1))
    for key in ("chain", "detect"):
        prof = next(v for k, v in res[key].items() if k.startswith("prof"))
        prof["top"] = prof["top"][:6]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
