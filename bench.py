"""audian-tpu benchmarks.

BASELINE.md target: full NFFT-256/50% spectrogram + 2-40 kHz bandpass +
envelope over a 1 hour x 16 channel x 96 kHz recording in under 2 s on
one accelerator.

Five metrics, one JSON line each (plus two opt-in modes: ``--stress``
for the larger-than-device-memory single-RF64-file batch leg and
``--slow-io`` for the FLAC-vs-WAV comparison under emulated slow
storage):

1. ``io+compute``: the end-to-end path — a real two-file PCM-16
   recording on disk read through :class:`audian_tpu.data.AudioLoader`
   (background block prefetch on), int16 host->device upload, the fused
   chain, fenced stats.  ``vs_baseline`` is the real-time factor
   (recording seconds processed per wall second; target 1x).  The
   ``components`` field breaks the wall into read / upload / dispatch /
   fence, so a regression in the overlap machinery is distinguishable
   from the disk (the page cache is dropped first when permitted).
1b. ``io+compute FLAC``: the same pipeline decoding a FLAC container of
   identical PCM at 8 channels (the FLAC spec ceiling) against a
   same-shape WAV baseline: the compressed path wins only where storage
   bandwidth is below ``decode_rate x (1 - flac/wav bytes)``; the
   components show which regime the host is in.
2. ``batch song-detect envelope``: detect()'s front half (the
   ``audian-songdetector`` hot loop) on the fused decimating path
   (``ops/envdet.py``) over device-resident chunks; ``vs_baseline`` is
   the speedup over the unfused chunk program.
2b. ``interactive session latencies``: a real headless DataBrowser
   session on the device — open+first render, scroll p50/p95 (page step
   + all trace/spectrogram tiles), cutoff scrub, NFFT step, auto-scale.
3. ``spectrogram+bandpass+envelope ... wall`` (the headline, printed
   LAST): the device compute path with on-device synthesized audio, so
   host transfers do not enter the number.  This is the BASELINE.md
   < 2 s target.  The chunks are device-resident in the loader's raw
   PCM-16 upload format (int16, sample = k/2^15 — what a real recording
   looks like after ``Data._put_raw``); the chain dequantizes on the
   device, bit-equal to feeding dequantized float32.

Every timed window ends in ``block_until_ready``.
"""

import json
import os
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp


RATE = 96000.0
CHANNELS = 16
HOURS = 1.0
NFFT, HOP = 256, 128
TARGET_S = 2.0
CHUNK = 1 << 22  # ~43.7 s of audio per device chunk

#: io+compute metric: two PCM-16 files of this many seconds each
IO_FILE_SECONDS = 30.0
IO_CHUNK = 1 << 21


def build_chain():
    from audian_tpu.models import get_preset

    # the headline chain IS the "bioacoustics" preset (2-40 kHz bandpass
    # + 500 Hz envelope + NFFT-256 spectrogram), so the benchmark and the
    # interactive/batch/sharded runs agree by construction.  eps is the
    # FIR truncation tolerance: 2e-6 keeps outputs well inside the 1e-5
    # scipy-oracle budget while shortening the envelope kernel.
    return get_preset("bioacoustics").fused(RATE, eps=2e-6)


def bench_kernel(fused):
    """Device compute path over synthesized chunks (the headline)."""
    hb, ha = fused.hb, fused.ha
    total_frames = int(HOURS * 3600 * RATE)
    nchunks = -(-total_frames // CHUNK)

    @jax.jit
    def make_chunk(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(0), seed)
        shape = (CHANNELS, hb + CHUNK + ha)
        t = (jnp.arange(shape[1], dtype=jnp.float32) / RATE)[None, :]
        tone = jnp.sin(2 * jnp.pi * 30000.0 * t) * (
            jnp.sin(2 * jnp.pi * 5.0 * t) > 0)
        x = 0.5 * tone + 0.05 * jax.random.normal(key, shape)
        # int16: the chunk is a PCM-16 recording resident on device in
        # the loader's raw16 upload format (sample = k/2^15); the chain
        # dequantizes on the device, outputs bit-equal to feeding the
        # dequantized f32 stream
        # (tests/test_fused.py::test_single_pass_chain_int16_input)
        return jnp.clip(jnp.round(x * 32768.0), -32768, 32767
                        ).astype(jnp.int16)

    chain = _stats_chain(fused, CHUNK)

    # distinct pre-generated chunks, device-resident
    chunks = jax.block_until_ready([make_chunk(i) for i in range(4)])

    # warm-up / compile
    jax.block_until_ready(chain(chunks[0]))

    # best of 3 identical passes
    best = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        outs = [chain(chunks[i % len(chunks)]) for i in range(nchunks)]
        jax.block_until_ready(outs)
        best = min(best, time.perf_counter() - t0)
    return best


def _stats_chain(fused, n):
    """The jitted chain over one extended chunk of ``n`` frames.  All
    three full outputs are computed; the chunk statistics are what is
    returned, so nothing large leaves the program — real runtimes
    likewise consume the stats for auto-leveling and stream the big
    outputs onward."""

    @jax.jit
    def chain(ext):
        _y, _e, _s, st = fused.chain_cf(ext, n, stats=True)
        return st["power"], st["env_sum"], st["psd_sum"]

    return chain


def bench_detect():
    """Batch song-detection envelope (detect()'s front half, the
    ``audian-songdetector`` hot loop) over 1 h x 16 ch x 96 kHz,
    device-resident chunks: the fused decimating path (``ops/envdet.py``
    — band-pass as one symmetric convolution, then squaring, smoothing
    and 1-in-19 decimation in one strided-window matmul) vs the unfused
    chunk program that computes every full-rate intermediate.
    Returns (fused_s, unfused_s)."""
    import scipy.signal as sps

    from audian_tpu.ops import FilterDesign
    from audian_tpu.analysis import events

    fdesign = FilterDesign.from_sos(
        sps.butter(1, (1000.0, 10000.0), "bandpass", fs=RATE,
                   output="sos"))
    edesign = FilterDesign.from_sos(
        sps.butter(1, 500.0, "lowpass", fs=RATE, output="sos"))
    step = int(np.round(RATE / min(500.0 * 10, RATE)))
    halo = events.detect_halo(fdesign, edesign)
    W = events._CHUNK + 2 * halo
    nchunks = -(-int(HOURS * 3600 * RATE) // events._CHUNK)

    @jax.jit
    def make_chunk(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(2), seed)
        t = (jnp.arange(W, dtype=jnp.float32) / RATE)[:, None]
        tone = jnp.sin(2 * jnp.pi * 6500.0 * t) * (
            jnp.sin(2 * jnp.pi * 1.0 * t) > 0)
        x = 0.4 * tone + 0.05 * jax.random.normal(key, (W, CHANNELS))
        return jnp.clip(jnp.round(x * 32768.0), -32768, 32767
                        ).astype(jnp.int16)

    chunks = jax.block_until_ready([make_chunk(i) for i in range(3)])

    envdet = events._make_envdet(fdesign, edesign, step, halo)
    assert envdet is not None, "detect geometry not coverable"

    def fused_fn(xw):
        return jnp.sum(envdet(xw, halo))

    @jax.jit
    def unfused_fn(xw):
        _y, env = events._band_env_device(fdesign, edesign, xw)
        return jnp.sum(events._strided_at(env, 0, step))

    def run(fn, reps):
        jax.block_until_ready(fn(chunks[0]))  # compile
        best = float("inf")
        for _rep in range(reps):
            t0 = time.perf_counter()
            outs = [fn(chunks[i % len(chunks)]) for i in range(nchunks)]
            jax.block_until_ready(outs)
            best = min(best, time.perf_counter() - t0)
        return best

    # the unfused path is only the comparison point: one rep keeps the
    # benchmark short
    unfused_s = run(unfused_fn, 1)
    fused_s = run(fused_fn, 3)
    return fused_s, unfused_s


def _bench_recording(container="wav", channels=CHANNELS):
    """Two cached recording files (written once, reused across runs).

    ``container="flac"`` holds the SAME int16 samples FLAC-compressed
    (encoded once by the FFmpeg oracle when available — fast C encode of
    the bench input; the measured path is the repo's own decoder — else
    by the repo encoder).  The FLAC legs run at ``channels<=8`` (the
    FLAC spec's channel ceiling).  Returns None when the FLAC variant
    cannot be produced."""
    from audian_tpu.data import wavio

    cache = Path(os.environ.get("XDG_CACHE_HOME",
                                Path.home() / ".cache"))
    cache = cache / "audian-tpu" / "bench"
    cache.mkdir(parents=True, exist_ok=True)
    frames = int(IO_FILE_SECONDS * RATE)
    files = []
    for i in range(2):
        f = cache / f"io_{channels}ch_{frames}f_{i}.wav"
        files.append(f)
        if f.exists() and f.stat().st_size > frames * channels * 2:
            continue
        t = (np.arange(frames, dtype=np.float64) + i * frames) / RATE
        tone = np.sin(2 * np.pi * 30000.0 * t) * (
            np.sin(2 * np.pi * 5.0 * t) > 0)
        rng = np.random.default_rng(i)
        x = (0.5 * tone[:, None]
             + 0.05 * rng.standard_normal((frames, channels))
             ).astype(np.float32)
        wavio.write_audio(f, x, RATE, encoding="PCM_16")
    if container == "wav":
        return files
    if channels > 8:
        return None  # FLAC stores at most 8 channels
    from audian_tpu import native
    from audian_tpu.data import flac

    flacs = []
    for f in files:
        g = f.with_suffix(".flac")
        flacs.append(g)
        if g.exists() and g.stat().st_size > 0:
            continue
        info = wavio.wav_info(f)
        q16 = np.empty((info[2], info[1]), np.int16)
        wavio.read_frames_raw16(f, 0, info[2], info, q16)
        try:
            if not native.ff_flac_encode(g, q16.astype(np.int32),
                                         int(info[0]), bits=16, level=5):
                flac.write_flac(g, q16, info[0])
        except Exception:
            return None
    return flacs


def _drop_page_cache():
    """Drop the OS page cache (root-only) so the io legs measure COLD
    reads — otherwise the recording written moments ago is served from
    RAM and the disk never shows up.  Returns False (and the metric
    notes warm cache) when not permitted."""
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3")
        return True
    except OSError:
        return False


def bench_io(fused, files, throttle_mbps=None):
    """Disk -> AudioLoader -> int16 upload -> fused chain -> fenced stats
    over a real multi-file recording (the BASELINE "end-to-end" framing;
    compile excluded via one warm-up chunk).

    Returns ``(wall_s, audio_seconds, components)`` where components
    break the wall down: ``read_s`` (disk + decode on the reader
    thread, which OVERLAPS the device work — components exceed the
    wall when the overlap is healthy), ``upload_s`` (host-side
    device_put time), ``bytes_read`` (container bytes), and
    ``open_s`` (loader open incl. the FLAC frame-index scan).

    ``throttle_mbps`` emulates slow storage (the ``--slow-io`` mode):
    the reader thread is paced so CONTAINER bytes flow at the given
    rate, the FLAC-vs-WAV break-even regime of field storage (SD cards,
    USB drives, NFS) that a fast local disk never shows.  Pacing by
    container bytes charges each format its own size, which is exactly
    the property that makes compressed containers win on slow
    storage."""
    from audian_tpu.data.loader import AudioLoader

    hb, ha = fused.hb, fused.ha
    ext_frames = hb + IO_CHUNK + ha

    @jax.jit
    def prep(q):
        # transpose on device (int16: half the bytes of an f32
        # transpose); the upload carries int16 and the chain dequantizes
        # on the device (bit-exact for PCM-16)
        return q.T

    chain = _stats_chain(fused, IO_CHUNK)

    t_open = time.perf_counter()
    loader = AudioLoader(files)
    if loader.raw16_capable:
        # charge per-file open work to open_s by touching the first and
        # last frame (for FLAC that is now the lazy index's bounded
        # bisection, not a whole-file sync scan)
        probe = np.empty((1, loader.channels), np.int16)
        loader.read_raw16_into(0, 1, probe)
        loader.read_raw16_into(loader.frames - 1, 1, probe)
    open_s = time.perf_counter() - t_open
    channels = loader.channels
    nchunks = loader.frames // IO_CHUNK
    comps = {"read_s": 0.0, "upload_s": 0.0, "dispatch_s": 0.0,
             "open_s": round(open_s, 4),
             "bytes_read": int(sum(Path(f).stat().st_size
                                   for f in files))}

    # persistent host staging: the read path reuses two alternating
    # int16 upload buffers (two so a device_put still in flight never
    # races the next chunk's rewrite).  PCM-16 sources read
    # their raw quantized samples straight into the upload buffer
    # (loader.read_raw16_into — bit-exact vs decode+requantize, and skips
    # several full host passes); other encodings decode to f32 and
    # quantize.
    qbufs = [np.empty((ext_frames, loader.channels), np.int16)
             for _ in range(2)]
    ext = (None if loader.raw16_capable
           else np.zeros((ext_frames, loader.channels), np.float32))

    total_bytes = comps["bytes_read"]
    bytes_per_chunk = total_bytes * IO_CHUNK / max(loader.frames, 1)
    throttle_state = {"t0": None, "bytes": 0.0}

    def read_ext(k):
        t_read = time.perf_counter()
        try:
            return _read_ext(k)
        finally:
            if throttle_mbps:
                # pace the reader to the emulated storage rate: this
                # chunk's share of the CONTAINER bytes may not arrive
                # faster than the (virtual) medium delivers them
                st = throttle_state
                if st["t0"] is None:
                    st["t0"] = t_read
                st["bytes"] += bytes_per_chunk
                ready = st["t0"] + st["bytes"] / (throttle_mbps * 2**20)
                now = time.perf_counter()
                if ready > now:
                    time.sleep(ready - now)
            comps["read_s"] += time.perf_counter() - t_read

    def _read_ext(k):
        start = k * IO_CHUNK - hb
        lo = max(start, 0)
        hi = min(start + ext_frames, loader.frames)
        q = qbufs[k % 2]
        if ext is None:
            if lo > start:
                q[: lo - start] = 0
            if hi - start < ext_frames:
                q[hi - start :] = 0
            loader.read_raw16_into(lo, hi - lo, q[lo - start : hi - start])
            return q
        if lo > start:
            ext[: lo - start] = 0.0
        if hi - start < ext_frames:
            ext[hi - start :] = 0.0
        loader._read_into(lo, hi - lo, ext[lo - start : hi - start])
        np.multiply(ext, 32768.0, out=ext)
        np.rint(ext, out=ext)
        q[:] = ext  # cast copy into the persistent int16 buffer
        return q

    # warm-up / compile on the first chunk's shapes
    jax.block_until_ready(chain(prep(jax.device_put(read_ext(0)))))

    # one-chunk read-ahead: disk decode of chunk k+1 overlaps chunk k's
    # upload+compute; the reader rewrites a buffer only after the next
    # put of the other one has been issued — hence two buffers
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        comps["read_s"] = 0.0  # discount the warm-up chunk's read
        throttle_state["t0"] = None  # restart the pacing clock too
        throttle_state["bytes"] = 0.0
        t0 = time.perf_counter()
        out = None
        fut = pool.submit(read_ext, 0)
        for k in range(nchunks):
            q = fut.result()
            if k + 1 < nchunks:
                fut = pool.submit(read_ext, k + 1)
            t_put = time.perf_counter()
            dq = jax.device_put(q)
            t_disp = time.perf_counter()
            comps["upload_s"] += t_disp - t_put
            out = chain(prep(dq))
            comps["dispatch_s"] += time.perf_counter() - t_disp
        t_fence = time.perf_counter()
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - t0
        comps["fence_s"] = round(time.perf_counter() - t_fence, 4)
    loader.close()
    comps["read_s"] = round(comps["read_s"], 4)
    comps["upload_s"] = round(comps["upload_s"], 4)
    comps["dispatch_s"] = round(comps["dispatch_s"], 4)
    audio_seconds = nchunks * IO_CHUNK / RATE
    return elapsed, audio_seconds, comps


#: stress leg: int16 bytes synthesized = this fraction of the device
#: memory JAX may use; >1 proves the chunked drivers stream with a
#: bounded device working set — an accumulating buffer would run the
#: device out of memory
STRESS_MEMORY_FRACTION = 1.05


def bench_stress(device_bytes=None):
    """Opt-in (``--stress`` / ``AUDIAN_TPU_STRESS=1``): the batch
    drivers over a recording LARGER than device memory at int16, stored
    as ONE RF64 file (>4 GiB single-file WAV — `data/wavio.py:WavWriter`).
    ``device_bytes`` defaults to the first device's ``bytes_limit``.

    - the corpus is written once as a single RF64 recording and read
      back through the real loader path (``AudioLoader.read_raw16_into``
      — the ``audian-songdetector`` CLI's exact load), timing the disk
      leg separately;
    - ``detect`` (the songdetector pipeline) streams the recording
      through the chunked fused device path; completing at all is the
      bounded-device-memory assertion (the input alone exceeds device
      memory),
      and three interior windows are re-computed through the exact host
      scipy float64 path and compared (the chunked == whole contract at
      stress scale).  Reference analog: whole-file batch detection,
      `/root/reference/songdetector.py:745-767`;
    - ``audian-compress`` builds the min/max overview artifact over the
      SAME single RF64 file through the real CLI.

    Prints one JSON line: sustained samples/s over the detect leg,
    ``vs_baseline`` = real-time factor, and a components breakdown —
    ``read_s`` (single-file disk read + its MB/s), ``upload_s`` (host->
    device transfers inside the chunk driver), ``compute_s``
    (device dispatch + decimated-envelope pulls, which fence each
    chunk), so an overlap/driver regression is distinguishable from
    the disk."""
    import shutil
    import tempfile

    from audian_tpu.analysis import events
    from audian_tpu.data.loader import AudioLoader
    from audian_tpu.data.wavio import WavWriter
    from audian_tpu.utils import trace as _trace

    if device_bytes is None:
        device_bytes = jax.devices()[0].memory_stats()["bytes_limit"]
    frames = int(STRESS_MEMORY_FRACTION * device_bytes / (CHANNELS * 2))
    frames -= frames % (1 << 21)
    rec_seconds = frames / RATE
    tmp = Path(tempfile.mkdtemp(prefix="audian_stress_"))
    try:
        # ONE RF64 file: blockwise int16 synthesis streamed to disk
        # (bounded host RAM; WavWriter promotes past the 4 GiB cap)
        rec = tmp / "stress.wav"
        rng = np.random.default_rng(0)
        blk = 1 << 22
        t_write = time.perf_counter()
        with WavWriter(rec, RATE, CHANNELS) as w:
            for a in range(0, frames, blk):
                b = min(a + blk, frames)
                t = np.arange(a, b, dtype=np.float64) / RATE
                tone = 0.4 * np.sin(2 * np.pi * 6500.0 * t) * (
                    np.sin(2 * np.pi * 1.0 * t) > 0)
                seg = (tone[:, None]
                       + 0.05 * rng.standard_normal((b - a, CHANNELS)))
                np.clip(np.round(seg * 32768.0), -32768, 32767, out=seg)
                w.write(seg.astype(np.int16))
        write_s = time.perf_counter() - t_write
        if frames * CHANNELS * 2 > (1 << 32):  # full-size runs only
            assert rec.stat().st_size > (1 << 32), "corpus must be >4 GiB"
            with rec.open("rb") as f:
                assert f.read(4) == b"RF64", "corpus must be ONE RF64"

        # the CLI's load path: one out-of-core open + a raw16 bulk read
        cold = _drop_page_cache()
        t_read = time.perf_counter()
        ld = AudioLoader(rec, prefetch=False)
        assert ld.frames == frames and ld.raw16_capable
        x = np.empty((frames, CHANNELS), np.int16)
        ld.read_raw16_into(0, frames, x)
        ld.close()
        read_s = time.perf_counter() - t_read
        nbytes = rec.stat().st_size

        _trace.clear()
        _trace.enable(log=False)
        t0 = time.perf_counter()
        # envelopefilter="none" keeps res["envelope"] pristine so the
        # oracle windows below compare the actual chunked-path output
        # (the default "apply" rewrites the envelope inside songs)
        res = events.detect(x, RATE, verbose=0, return_filtered=False,
                            envelopefilter="none")
        detect_s = time.perf_counter() - t0
        upload_ms = sum(e.get("ms", 0.0)
                        for e in _trace.events("detect.upload"))
        compute_ms = sum(e.get("ms", 0.0)
                         for e in _trace.events("detect.chunk"))
        _trace.disable()

        # slice-equality vs the exact host float64 scipy path (small
        # inputs route there automatically): three interior windows
        env = res["envelope"]
        step = int(round(RATE / res["envrate"]))
        ctx = ((1 << 17) // step) * step   # >> the bucketed filter halo
        wlen = ((1 << 19) // step) * step
        checks = 0
        for wstart in (frames // 7, frames // 2, frames - 2 * wlen):
            a = (wstart // step) * step
            lo = a - ctx
            assert lo % step == 0 and lo > 0
            _f, env_ref, er = events.band_env(
                x[lo : a + wlen + ctx], RATE, 1000.0, 10000.0, 500.0,
                return_filtered=False)
            assert er == res["envrate"]
            j0 = ctx // step
            npts = wlen // step
            got = np.asarray(env[a // step : a // step + npts])
            ref = np.asarray(env_ref[j0 : j0 + npts])
            scale = max(float(np.max(np.abs(ref))), 1e-9)
            err = float(np.max(np.abs(got - ref))) / scale
            assert err < 2e-5, (wstart, err)
            checks += 1
        del x

        # compress leg: the real CLI over the SAME single RF64 file
        from audian_tpu.cli import compress

        t0 = time.perf_counter()
        rc = compress.main([str(rec)])
        compress_s = time.perf_counter() - t0
        assert rc == 0
        assert (tmp / "stress-fulltrace.wav").exists()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({
        "metric": (f"STRESS detect over {rec_seconds / 3600:.2f}h x "
                   f"{CHANNELS}ch x 96kHz int16, ONE RF64 file "
                   f"({frames * CHANNELS * 2 / 2**30:.1f} GiB > device "
                   "memory; "
                   "completion = bounded device memory; sustained "
                   "samples/s over the detect leg; vs_baseline = "
                   "real-time factor)"),
        "value": round(frames * CHANNELS / detect_s / 1e6, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(rec_seconds / detect_s, 2),
        "components": {
            "detect_wall_s": round(detect_s, 2),
            "upload_s": round(upload_ms / 1000.0, 2),
            "compute_s": round(compute_ms / 1000.0, 2),
            "read_s": round(read_s, 2),
            "read_MBps": round(nbytes / read_s / 2**20, 1),
            "write_s": round(write_s, 2),
            "cold_cache": cold,
            "compress_wall_s": round(compress_s, 2),
            "oracle_windows_checked": checks,
            "songs_found_ch0": len(res["onsets"][0]),
        },
    }))


def bench_interactive(files):
    """Interactive session latencies.

    Drives a real headless :class:`DataBrowser` session over the cached
    8-channel io recording on the actual device and measures the verbs
    the README quotes: open + first full render, scroll (page step +
    every channel's trace tile + the all-channel spectrogram tile +
    sticky levels — the Qt ``refresh`` loop's work), cutoff scrub (full
    recompute + re-render, zero recompiles), NFFT resolution step after
    the targeted warm, and amplitude auto-scale.  Returns the metric
    dict; ``value`` is the scroll p50 and ``vs_baseline`` the headroom
    under the reference's 50 ms interactive tick (BASELINE.md design
    constants)."""
    from audian_tpu.app import DataBrowser

    def render(b):
        for c in b.show_channels:
            b.trace_tile("filtered", c)
        for c in b.show_channels:
            b.spec_tile(c, quantize=True)

    t0 = time.perf_counter()
    b = DataBrowser([str(f) for f in files], buffer_time=30.0).open()
    b.set_times(0.0, 2.0)
    render(b)
    open_s = time.perf_counter() - t0

    # steady-state scrolls (the compile cache is warm after the first)
    b.time_page_down()
    render(b)
    dts = []
    for k in range(24):
        t0 = time.perf_counter()
        b.time_page_down() if k % 16 < 12 else b.time_page_up()
        render(b)
        dts.append(time.perf_counter() - t0)
    dts = np.sort(np.asarray(dts))
    scroll_p50 = float(dts[len(dts) // 2])
    scroll_p95 = float(dts[int(len(dts) * 0.95)])

    # cutoff scrub: redesign + full-window recompute + re-render,
    # interactivity contract = ZERO recompiles (traced designs).  The
    # FIRST real design replaces the pass-through program (a legitimate
    # one-time compile, `graph/nodes.py:static_key`), so it runs before
    # the contract snapshot.
    b.update_filter(lowpass_cutoff=40000.0)
    render(b)
    ncomp0 = b.data.executor.cache_size
    scrub = []
    for k, lp in enumerate((30000.0, 35000.0, 32000.0, 38000.0)):
        t0 = time.perf_counter()
        b.update_filter(lowpass_cutoff=lp)
        render(b)
        scrub.append(time.perf_counter() - t0)
    assert b.data.executor.cache_size == ncomp0, "cutoff scrub recompiled"
    scrub_s = float(np.median(scrub))

    # NFFT step across two warmed buckets
    b.warm_resolutions(nffts=(256, 512))
    steps = []
    for nfft in (512, 256, 512, 256):
        t0 = time.perf_counter()
        b.set_resolution(nfft=nfft)
        render(b)
        steps.append(time.perf_counter() - t0)
    nfft_s = float(np.median(steps))

    # amplitude auto-scale (device window extrema)
    autos = []
    for _ in range(4):
        t0 = time.perf_counter()
        b.auto_ampl()
        autos.append(time.perf_counter() - t0)
    auto_s = float(np.median(autos))
    b.close()

    return {
        "metric": ("interactive session latencies (30s x 8ch x 96kHz "
                   "view on-chip: scroll p50 end-to-end incl. all trace "
                   "+ spectrogram tiles; vs_baseline = headroom under "
                   "the 50 ms interactive tick; components carry the "
                   "other verbs)"),
        "value": round(scroll_p50 * 1e3, 2),
        "unit": "ms",
        "vs_baseline": round(0.050 / scroll_p50, 2),
        "components": {
            "open_warm_s": round(open_s, 2),
            "scroll_p50_ms": round(scroll_p50 * 1e3, 2),
            "scroll_p95_ms": round(scroll_p95 * 1e3, 2),
            "cutoff_scrub_s": round(scrub_s, 3),
            "nfft_step_s": round(nfft_s, 3),
            "autoscale_ms": round(auto_s * 1e3, 2),
        },
    }


#: --slow-io emulated storage bandwidth, chosen below the break-even of
#: the bench corpus (``decode_rate x (1 - flac/wav bytes)``) so the
#: compressed container's regime is demonstrated, not just derived
SLOW_IO_MBPS = 12.0


def bench_slow_io(fused):
    """Opt-in (``--slow-io``): the FLAC-vs-WAV io legs under emulated
    slow storage.  Reads are paced to ``SLOW_IO_MBPS`` of container
    bytes; the FLAC leg moves fewer bytes, so it must WIN here
    (``vs_baseline > 1``) — the regime field storage lives in."""
    flac_files = _bench_recording("flac", channels=8)
    if flac_files is None:
        print(json.dumps({"metric": "slow-io FLAC demo skipped "
                          "(no FLAC encoder available)", "value": 0,
                          "unit": "s", "vs_baseline": 0}))
        return
    wav_files = _bench_recording("wav", channels=8)
    _drop_page_cache()
    wav_s, _sec, wav_comps = bench_io(fused, wav_files,
                                      throttle_mbps=SLOW_IO_MBPS)
    _drop_page_cache()
    fl_s, fl_sec, fl_comps = bench_io(fused, flac_files,
                                      throttle_mbps=SLOW_IO_MBPS)
    fl_comps["wav_wall_s"] = round(wav_s, 4)
    fl_comps["wav_read_s"] = wav_comps["read_s"]
    fl_comps["throttle_MBps"] = SLOW_IO_MBPS
    print(json.dumps({
        "metric": (f"io+compute FLAC->chain {fl_sec:.0f}s x 8ch x "
                   f"96kHz wall under {SLOW_IO_MBPS:.0f} MB/s emulated "
                   "storage (container bytes paced; vs_baseline = "
                   "same-shape WAV wall / FLAC wall — the compressed "
                   "container's regime, demonstrated not derived)"),
        "value": round(fl_s, 4),
        "unit": "s",
        "vs_baseline": round(wav_s / fl_s, 3),
        "components": fl_comps,
    }))


def main():
    import sys

    import audian_tpu
    audian_tpu.enable_compilation_cache()

    if "--stress" in sys.argv[1:] or os.environ.get("AUDIAN_TPU_STRESS"):
        bench_stress()
        return

    if "--slow-io" in sys.argv[1:] or os.environ.get("AUDIAN_TPU_SLOW_IO"):
        bench_slow_io(build_chain())
        return

    fused = build_chain()

    wav_files = _bench_recording("wav")
    cold = _drop_page_cache()
    io_elapsed, audio_seconds, comps = bench_io(fused, wav_files)
    comps["cold_cache"] = cold
    print(json.dumps({
        "metric": (f"io+compute disk->chain "
                   f"{audio_seconds:.0f}s x {CHANNELS}ch x 96kHz wall"),
        "value": round(io_elapsed, 4),
        "unit": "s",
        "vs_baseline": round(audio_seconds / io_elapsed / 1.0, 3),
        "components": comps,
    }))

    # the FLAC leg runs at 8 channels (the FLAC spec's ceiling) with a
    # matching 8-channel WAV run as its private baseline, so the ratio
    # isolates the container (bytes + decode), not a channel-count change
    flac_files = _bench_recording("flac", channels=8)
    if flac_files is not None:
        cold = _drop_page_cache()
        w8_elapsed, _s8, w8_comps = bench_io(
            fused, _bench_recording("wav", channels=8))
        cold = _drop_page_cache() and cold
        fl_elapsed, fl_seconds, fl_comps = bench_io(fused, flac_files)
        fl_comps["cold_cache"] = cold
        fl_comps["wav_wall_s"] = round(w8_elapsed, 4)
        fl_comps["wav_read_s"] = w8_comps["read_s"]
        print(json.dumps({
            "metric": (f"io+compute FLAC->chain "
                       f"{fl_seconds:.0f}s x 8ch x 96kHz wall "
                       "(same PCM from a FLAC container; vs_baseline = "
                       "same-shape WAV wall / FLAC wall — FLAC wins "
                       "when storage bandwidth is below decode_rate x "
                       "(1 - flac/wav bytes): see components.read_s "
                       "vs wav_read_s)"),
            "value": round(fl_elapsed, 4),
            "unit": "s",
            "vs_baseline": round(w8_elapsed / fl_elapsed, 3),
            "components": fl_comps,
        }))

    print(json.dumps(bench_interactive(_bench_recording("wav",
                                                        channels=8))))

    detect_s, detect_unfused_s = bench_detect()
    print(json.dumps({
        "metric": ("batch song-detect envelope 1h x 16ch x 96kHz wall "
                   "(fused decimating path; vs_baseline = speedup over "
                   "the unfused chunk program)"),
        "value": round(detect_s, 4),
        "unit": "s",
        "vs_baseline": round(detect_unfused_s / detect_s, 3),
    }))

    elapsed = bench_kernel(fused)
    print(json.dumps({
        "metric": "spectrogram+bandpass+envelope 1h x 16ch x 96kHz wall",
        "value": round(elapsed, 4),
        "unit": "s",
        "vs_baseline": round(TARGET_S / elapsed, 3),
    }))


if __name__ == "__main__":
    main()
