"""Streaming prefetcher and the multi-resolution sweep."""

import numpy as np
import pytest

from audian_tpu.stream import BlockPrefetcher
from audian_tpu.ops import spectrogram_sweep, db_quantize, spectrogram


class FakeSource:
    def __init__(self, n=5000, channels=2):
        self.frames = n
        self.channels = channels
        self.data = np.arange(n * channels, dtype=np.float32).reshape(
            n, channels)
        self.reads = 0

    def _read(self, start, nframes):
        self.reads += 1
        return self.data[start : start + nframes]


def test_prefetcher_correct_and_caching():
    src = FakeSource()
    pf = BlockPrefetcher(src, block_frames=1000, max_blocks=4, read_ahead=1)
    out = pf.read(500, 1000)  # spans blocks 0 and 1
    np.testing.assert_array_equal(out, src.data[500:1500])
    pf.drain()
    reads_after_first = src.reads
    out2 = pf.read(600, 800)  # fully cached now
    np.testing.assert_array_equal(out2, src.data[600:1400])
    assert src.reads == reads_after_first
    assert pf.hits > 0
    # read-ahead fetched block 2 in the background
    assert 2 in pf.cached_blocks()
    pf.close()


def test_prefetcher_lru_eviction():
    src = FakeSource(n=10000)
    pf = BlockPrefetcher(src, block_frames=1000, max_blocks=2, read_ahead=0)
    pf.read(0, 500)
    pf.read(3000, 500)
    pf.read(8000, 500)
    assert len(pf.cached_blocks()) <= 2
    assert 0 not in pf.cached_blocks()
    pf.close()


def test_prefetcher_edges():
    src = FakeSource(n=2500)
    pf = BlockPrefetcher(src, block_frames=1000, read_ahead=2)
    tail = pf.read(2300, 500)  # clamped at EOF
    np.testing.assert_array_equal(tail, src.data[2300:2500])
    assert pf.read(5000, 10).shape == (0, 2)
    pf.close()


def test_spectrogram_sweep_matches_individuals(rng):
    rate = 48000.0
    x = rng.standard_normal(20000).astype(np.float32)
    sweep = spectrogram_sweep(x, rate, nffts=(128, 256, 512))
    for nfft, sxx in sweep.items():
        want = np.asarray(spectrogram(x, rate, nfft, nfft // 2))
        np.testing.assert_allclose(np.asarray(sxx), want, rtol=1e-5,
                                   atol=1e-10)
        assert sxx.shape[-1] == nfft // 2 + 1


def test_db_quantize():
    p = np.array([1e-20, 1e-2, 1.0])
    q = np.asarray(db_quantize(p, -40.0, 0.0))
    assert q.dtype == np.uint8
    assert q[0] == 0 and q[2] == 255 and 0 < q[1] < 255


def test_loader_prefetch_integration(tmp_path, rng):
    from audian_tpu.data import wavio
    from audian_tpu.data.loader import AudioLoader

    x = 0.1 * rng.standard_normal((50000, 2))
    p = tmp_path / "pf.wav"
    wavio.write_audio(p, x, 48000.0, encoding="FLOAT")
    ld = AudioLoader(p, prefetch=True)
    got = ld._read(1000, 3000)
    np.testing.assert_allclose(got, x[1000:4000], atol=1e-7)
    # windowed access goes through the cache too
    ld.update_time(0.1, 0.3)
    np.testing.assert_allclose(ld[9000:9100], x[9000:9100], atol=1e-7)
    ld.close()


def test_prefetch_overlaps_read_with_compute():
    """Sequential scrolling against a slow reader: background read-ahead
    hides block reads behind the caller's compute, so wall time stays
    under the serial read+compute sum (SURVEY.md section 7's
    double-buffered feed, now the default path)."""
    import time

    class SlowSource:
        frames = 8000
        channels = 1

        def _read(self, start, n):
            time.sleep(0.1)
            n = min(n, self.frames - start)
            return np.zeros((n, 1), np.float32)

    pf = BlockPrefetcher(SlowSource(), block_frames=1000, read_ahead=1)
    nsteps = 6
    for k in range(nsteps):
        pf.read(k * 1000, 1000)
        time.sleep(0.4)  # downstream compute, 4x one read
    pf.close()
    # pf.hits counts blocks the background thread had fetched BEFORE the
    # foreground asked — a hit IS the overlap property (the read happened
    # during the compute sleep).  No wall-clock assertions: both per-step
    # latency thresholds and total-wall bounds flaked under CI load.
    assert pf.hits >= nsteps - 2, f"only {pf.hits} read-ahead hits"


def test_prefetch_direction_bias():
    src = FakeSource(n=10000)
    pf = BlockPrefetcher(src, block_frames=1000, read_ahead=2)
    pf.read(5000, 500)   # block 5
    pf.read(4000, 500)   # block 4: moving backwards
    pf.drain()
    cached = pf.cached_blocks()
    assert 3 in cached and 2 in cached  # read ahead towards lower blocks
    pf.close()


def test_prefetch_invalidate_on_unwrap(tmp_path, rng):
    from audian_tpu.data import wavio
    from audian_tpu.data.loader import AudioLoader

    x = 0.1 * rng.standard_normal((20000, 1))
    p = tmp_path / "inv.wav"
    wavio.write_audio(p, x, 48000.0, encoding="FLOAT")
    ld = AudioLoader(p)  # prefetch defaults ON
    assert ld._prefetcher is not None
    ld._read(0, 5000)
    assert ld._prefetcher.cached_blocks()
    ld.set_unwrap(1.5)
    assert not ld._prefetcher.cached_blocks()
    ld.close()


def test_read_into_matches_read_without_alias():
    src = FakeSource(n=10000)
    pf = BlockPrefetcher(src, block_frames=1000, read_ahead=0)
    out = np.empty((2500, 2), np.float32)
    got = pf.read_into(750, 2500, out)  # spans blocks 0-3
    np.testing.assert_array_equal(got, src.data[750:3250])
    assert got.base is out or got is out
    # out owns its storage: later cache churn must not mutate it
    snap = out.copy()
    for b in range(10):
        pf.read(b * 1000, 1000)
    pf.drain()
    np.testing.assert_array_equal(out, snap)
    pf.close()


def test_block_buffer_freelist_recycles_only_unreferenced():
    """Evicted block storage is reused (bounding the process's unique
    first-touch footprint), but
    never while a caller still holds a read() view of it."""

    class OutSource(FakeSource):
        def _read(self, start, nframes, out=None):
            self.reads += 1
            n = min(nframes, self.frames - start)
            if out is None:
                return self.data[start : start + n]
            out[:n] = self.data[start : start + n]
            return out[:n]

    src = OutSource(n=12000)
    pf = BlockPrefetcher(src, block_frames=1000, max_blocks=2, read_ahead=0)
    held = pf.read(0, 100)          # view of block 0
    before = held.copy()
    for b in range(1, 12):          # churn far past the 2-block cache
        pf.read(b * 1000, 1000)
    pf.drain()
    assert len(pf._free) > 0, "eviction never fed the freelist"
    np.testing.assert_array_equal(held, before)  # view survived the churn
    # freelist buffers actually get reused by later loads
    free_ids = {id(a) for a in pf._free}
    pf.read(0, 1000)
    with pf._lock:
        reused = {id(a.base if a.base is not None else a)
                  for a in pf._cache.values()} & free_ids
    assert reused, "freelist buffer was not reused"
    pf.close()


def test_move_buffer_spare_swap_roundtrip(tmp_path, rng):
    from audian_tpu.data import wavio
    from audian_tpu.data.loader import AudioLoader

    x = 0.1 * rng.standard_normal((200000, 2))
    p = tmp_path / "swap.wav"
    wavio.write_audio(p, x, 48000.0, encoding="FLOAT")
    ld = AudioLoader(p, buffer_time=1.0, back_time=0.25, prefetch=False)
    ld.update_time(0.0, 0.5)
    first = ld[1000:2000].copy()
    buf0 = ld.buffer
    ld.update_time(2.5, 3.0)   # non-overlapping: old buffer retired
    ld.update_time(0.0, 0.5)   # same shape: storage recycled
    assert ld.buffer is buf0   # ping-pongs between two warm buffers
    np.testing.assert_array_equal(ld[1000:2000], first)
    ld.close()


def test_prefetch_no_stale_block_after_invalidate():
    """A read racing invalidate() must re-read under the new epoch
    instead of serving samples decoded with the old parameters."""
    import threading

    class Source:
        frames = 4000
        channels = 1

        def __init__(self):
            self.gain = 1.0
            self.slow_once = threading.Event()

        def _read(self, start, n):
            if not self.slow_once.is_set():
                self.slow_once.set()
                # invalidate() fires while this first read is in flight
                pf.invalidate()
                src.gain = 2.0
            n = min(n, self.frames - start)
            return np.full((n, 1), self.gain, np.float32)

    src = Source()
    pf = BlockPrefetcher(src, block_frames=1000, read_ahead=0)
    out = pf.read(0, 100)
    assert float(out[0, 0]) == 2.0  # new-epoch data, not the stale read
    pf.close()


def test_freelist_concurrent_churn_no_corruption():
    """Hammer the prefetcher from two reader threads while invalidating:
    recycled block buffers must never leak stale samples into a
    concurrent reader's output (the refcount guard in _recycle)."""
    import threading

    class OutSource(FakeSource):
        def _read(self, start, nframes, out=None):
            self.reads += 1
            n = min(nframes, self.frames - start)
            if out is None:
                return self.data[start : start + n]
            out[:n] = self.data[start : start + n]
            return out[:n]

    src = OutSource(n=64000)
    pf = BlockPrefetcher(src, block_frames=1000, max_blocks=3, read_ahead=1)
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        out = np.empty((1500, 2), np.float32)
        for _ in range(60):
            s = int(rng.integers(0, src.frames - 1500))
            got = pf.read_into(s, 1500, out)
            if not np.array_equal(got, src.data[s : s + 1500]):
                errors.append(s)
                return

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for _ in range(10):
        pf.invalidate()
    for t in threads:
        t.join()
    pf.drain()
    assert not errors, f"corrupted reads at {errors[:3]}"
    pf.close()


def test_read_after_close_serves_synchronously():
    """read() after close() (or racing drain()) must serve the request
    synchronously instead of crashing when read-ahead scheduling hits
    the shut-down executor."""
    src = FakeSource()
    pf = BlockPrefetcher(src, block_frames=1000, read_ahead=2)
    out1 = pf.read(0, 100)
    pf.close()
    out2 = pf.read(3000, 100)  # uncached block + read-ahead attempts
    np.testing.assert_array_equal(out1, src.data[:100])
    np.testing.assert_array_equal(out2, src.data[3000:3100])


def test_miss_on_pending_block_waits_instead_of_rereading():
    """A cache miss on a block whose background prefetch is already in
    flight must wait on THAT read, not issue a second full read of the
    same block in parallel (two competing multi-second reads of the
    same bytes on a slow disk)."""
    import threading

    class SlowSource(FakeSource):
        def __init__(self):
            super().__init__()
            self.release = threading.Event()
            self.reads_of = []

        def _read(self, start, nframes):
            self.reads_of.append(start)
            if start == 2000:  # the prefetched block
                self.release.wait(10)
            return super()._read(start, nframes)

    src = SlowSource()
    pf = BlockPrefetcher(src, block_frames=1000, max_blocks=4,
                         read_ahead=1)
    pf.read(500, 1000)  # blocks 0+1; schedules block 2 (slow)
    for _ in range(100):
        if 2000 in src.reads_of:
            break
        import time
        time.sleep(0.01)
    assert 2000 in src.reads_of, "prefetch of block 2 never started"
    got = []
    t = threading.Thread(
        target=lambda: got.append(pf.read(2000, 500)))
    t.start()
    import time
    time.sleep(0.2)  # the miss must be blocked on the pending read...
    src.release.set()
    t.join(10)
    assert got and np.array_equal(got[0], src.data[2000:2500])
    # ...and block 2 was read from the source exactly once
    assert src.reads_of.count(2000) == 1
    pf.close()
