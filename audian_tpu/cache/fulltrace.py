"""Whole-recording min/max overview with persistent cache.

Rebuild of the reference's ``CompressedData``
(`src/audian/compresseddata.py:25-305`): the min/max pyramid over the whole
(out-of-core) recording for the overview plot, computed in the background,
persisted either next to the data as ``<stem>-fulltrace.wav`` or in a
JSON-indexed LRU user cache — artifact-format compatible (double-encoded
WAV with the rate scaled by 1e6/1e3 to dodge WAV's rate limits,
`src/audian/compresseddata.py:147-155,198-202`).

Compute backends, replacing the fork-server process pool over a locked
shared array (`compresseddata.py:104-122`):

- C++ threads (``audian_tpu.native.file_minmax``, lock-free block stripes)
  for out-of-core single files;
- the in-memory reshape-reduce for short recordings;
- optionally the device minmax of the sharded pipeline when data is
  already flowing through the device (batch CLIs).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from datetime import datetime
from pathlib import Path

import numpy as np

from ..version import audian_dirs
from ..data import wavio
from .. import native

__all__ = ["FullTraceData"]

#: bytes of source frames per native min/max call on the single-file
#: path — the cancellation granularity of a background overview scan
#: (~2-3 s of disk time per slice on this host's cold reads)
_NATIVE_SLICE_BYTES = 16 << 20



def _read_index(index_path):
    """The cache index, tolerating a missing or corrupt file (a killed
    writer must not poison every later open)."""
    try:
        files = json.loads(index_path.read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(files, dict):
        return {}  # valid JSON of the wrong shape is corruption too

    # entries must carry the lookup schema (load_data reads these keys
    # unconditionally); drop anything else so callers can rely on it
    def _valid(v):
        return (isinstance(v, dict)
                and isinstance(v.get("first"), str)
                and isinstance(v.get("last"), str)
                and isinstance(v.get("rate"), (int, float)))

    return {k: v for k, v in files.items() if _valid(v)}


def _write_index(index_path, files):
    """Atomic index write (unique temp + rename — a shared temp name
    would let two concurrent writers truncate each other's file and
    crash on the rename)."""
    tmp = index_path.with_suffix(
        f".json.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps(files, indent=4))
    os.replace(tmp, index_path)


@contextlib.contextmanager
def _index_lock(cache):
    """Cross-process lock for read-modify-write cycles on the index:
    without it two savers (GUI + compress CLI) can pick the same free
    artifact name and silently serve one recording's overview for
    another."""
    try:
        import fcntl
    except ImportError:  # non-posix: best effort, no locking
        yield
        return
    with open(cache / "fulltraces.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)

class FullTraceData:
    """Background-computed min/max overview of one recording."""

    fulltraces_file = "fulltraces.json"
    max_files = 1000

    def __init__(self, data):
        """``data`` is an :class:`audian_tpu.data.AudioLoader` (or the raw
        trace of a :class:`audian_tpu.data.Data`)."""
        self.data = data
        self.times = None
        self.datas = None
        self.step = None
        self.short_data = True
        self._thread = None
        self._stop = threading.Event()
        self._cancelled = False
        #: last background-computation failure (overview may be partial)
        self.error = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def close(self):
        # cancel the worker: letting it stream the rest of a multi-GB
        # recording after the browser closed would contend with the new
        # session for the host's cores and cache a discarded overview
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self._thread = None

    # -- compute -----------------------------------------------------------------

    def start(self, max_pixel, do_short=True, background=True):
        """Begin computing the overview at ``<= 2*max_pixel`` columns
        (`src/audian/compresseddata.py:79-122` semantics: step =
        frames//max_pixel, interleaved min/max, times at half steps)."""
        if (self.times is not None and self.datas is not None
                and self.error is None and not self._cancelled):
            return  # a failed/cancelled run retries; a finished one does not
        self.error = None
        self._cancelled = False
        self._stop = threading.Event()
        # stamp the source NOW, before any bytes are read: a recording
        # re-exported DURING the (minutes-long) background compute must
        # not get the resulting stale overview stamped as fresh
        self._read_stamp = self._source_stamp()
        frames = self.data.frames
        step = max(1, frames // max_pixel)
        self.step = step
        nseg = -(-frames // step)
        self.times = (np.arange(2 * nseg) * (step / 2)
                      + 0.0) / self.data.rate
        if len(self.data.buffer) == frames:
            # short file: data is fully in memory, no background needed
            self.short_data = True
            if do_short:
                buf = np.asarray(self.data.buffer)
                self.datas = _interleaved_minmax(buf, step)
            return
        self.short_data = False
        self.datas = np.zeros((2 * nseg, self.data.channels))
        if background:
            self._thread = threading.Thread(
                target=self._compute, args=(step, True), daemon=True)
            self._thread.start()
        else:
            self._compute(step, False)

    def _compute(self, step, background=True):
        try:
            self._compute_body(step)
        except Exception as e:
            # keep the partial (zero-filled) overview for display, but
            # record the failure so start() retries instead of treating
            # the zeros as a finished overview
            self.error = e
            print(f"fulltrace computation failed: {e}")
            return
        if self._stop.is_set():
            # recording closed mid-compute: the zero-filled tail is NOT a
            # finished overview — do not cache it, and let a later
            # start() recompute instead of early-returning on it
            self._cancelled = True
            return
        if not background:
            # the synchronous caller (audian-compress) manages
            # persistence itself; saving here too would write the
            # artifact twice and churn the user cache's LRU
            return
        # persist as soon as the computation finishes so the NEXT session
        # loads instead of recomputing (the reference saves from its GUI
        # poll, `src/audian/fulltraceplot.py:182` — headless/batch runs
        # here have no poll, so the worker saves directly)
        try:
            self.save_data()
        except Exception:
            pass

    def _compute_body(self, step):
        out = self.datas
        if len(self.data.file_paths) == 1:
            info = self.data._infos[0]
            rate, channels, frames, enc, data_off = info
            native_ok = (self.data.unwrap_thresh <= 1e-3
                         and data_off is not None)
            if native_ok:
                # step-aligned ~16 MiB slices so close()'s stop flag is
                # honored between calls: ONE whole-file native call on a
                # multi-GB recording (the 11 GB RF64 case) would keep
                # the C++ read threads hammering the host's disk
                # for the rest of the scan after the session moved on
                tb = native._TAGS.get(enc)
                bpf = max(channels * ((tb[1] if tb else 16) // 8), 1)
                seg = max(step, _NATIVE_SLICE_BYTES // bpf // step * step)
                row = 0
                for s0 in range(0, frames, seg):
                    if self._stop.is_set():
                        return
                    part = native.file_minmax(
                        self.data.file_paths[0], data_off, enc, channels,
                        min(seg, frames - s0), step, start=s0)
                    if part is None:
                        native_ok = False
                        break
                    n = min(len(part), len(out) - row)
                    out[row : row + n] = part[:n]
                    row += n
            if not native_ok:
                part = self._compute_python(0, step)
                n = min(len(part), len(out))
                out[:n] = part[:n]
        else:
            # multi-file recordings: segments belong to the CONCATENATED
            # stream — per-file decimation would restart the segment grid
            # at every file boundary and shift the overview in time.
            # When every boundary falls ON the segment grid, the per-file
            # C++ fast path still produces the global grid.
            infos = self.data._infos
            aligned = (self.data.unwrap_thresh <= 1e-3
                       and all(i[4] is not None for i in infos)
                       and all(i[2] % step == 0 for i in infos[:-1]))
            if aligned:
                row = 0
                for k, path in enumerate(self.data.file_paths):
                    if self._stop.is_set():
                        return
                    info = infos[k]
                    part = native.file_minmax(path, info[4], info[3],
                                              info[1], info[2], step)
                    if part is None:
                        part = self._compute_python(k, step)
                    n = min(len(part), len(out) - row)
                    out[row : row + n] = part[:n]
                    row += n
            else:
                frames = self.data.frames
                nblock = max(step, (1 << 20) // step * step)
                unwrap = self.data.unwrap_thresh > 1e-3
                # sequential scan: thread the cumulative unwrap shift
                # across blocks (same reasoning as _compute_python —
                # _read_direct's random-access unwrap would restart the
                # shift at every block boundary and mis-level the rest
                # of the block when a wrap is still active there)
                carried = 0.0
                for start in range(0, frames, nblock):
                    if self._stop.is_set():
                        return
                    n = min(nblock, frames - start)
                    if unwrap and start > 0:
                        ext = self.data._read_raw(start - 1, n + 1)
                        ext, carried = wavio.unwrap(
                            ext, self.data.unwrap_thresh,
                            self.data.unwrap_clips, self.data.ampl_max,
                            start_shift=carried, return_shift=True)
                        buf = ext[1:]
                    elif unwrap:
                        buf, carried = wavio.unwrap(
                            self.data._read_raw(start, n),
                            self.data.unwrap_thresh,
                            self.data.unwrap_clips, self.data.ampl_max,
                            return_shift=True)
                    else:
                        buf = self.data._read_direct(start, n)
                    seg = _interleaved_minmax(buf, step)
                    r = 2 * (start // step)
                    out[r : r + len(seg)] = seg

    def _compute_python(self, k, step):
        """Fallback: block-strided numpy reduction over one file."""
        info = self.data._infos[k]
        frames = info[2]
        nseg = -(-frames // step)
        out = np.zeros((2 * nseg, info[1]))
        nblock = max(step, (1 << 20) // step * step)
        unwrap = self.data.unwrap_thresh > 1e-3
        # cumulative unwrap offset carried across blocks: this scan is
        # sequential, so unlike the loader's random-access windows the
        # overview can keep exact wrap state — a wrap still active at a
        # block boundary would otherwise reset and mis-level the rest of
        # that block
        carried = 0.0
        for start in range(0, frames, nblock):
            if self._stop.is_set():
                return out
            n = min(nblock, frames - start)
            if unwrap and start > 0:
                # one sample of left context seeds the boundary jump
                # detection; ``carried`` (the cumulative input-space
                # shift threaded through unwrap) keeps a wrap that is
                # still active at the boundary continuous — this scan is
                # sequential, so the overview can be exact where the
                # loader's random-access windows cannot
                ext = wavio.read_frames(self.data.file_paths[k],
                                        start - 1, n + 1, info)
                ext, carried = wavio.unwrap(
                    ext, self.data.unwrap_thresh, self.data.unwrap_clips,
                    self.data.ampl_max, start_shift=carried,
                    return_shift=True)
                buf = ext[1:]
            else:
                buf = wavio.read_frames(self.data.file_paths[k], start, n,
                                        info)
                if unwrap:
                    buf, carried = wavio.unwrap(
                        buf, self.data.unwrap_thresh,
                        self.data.unwrap_clips, self.data.ampl_max,
                        return_shift=True)
            seg = _interleaved_minmax(buf, step)
            out[2 * (start // step) : 2 * (start // step) + len(seg)] = seg
        return out

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def is_busy(self):
        return self._thread is not None and self._thread.is_alive()

    # -- persistence -----------------------------------------------------------

    @staticmethod
    def _encode_rate(rate):
        rate *= 1e6
        while rate > 2 ** 31:
            rate /= 1e3
        return rate

    def _local_path(self):
        fp = Path(self.data.filepath)
        return fp.with_name(fp.stem + "-fulltrace.wav")

    def _source_stamp(self):
        """(newest mtime, total bytes) over the source files — cached
        overviews of a recording that changed on disk are stale.  The
        reference matches cache entries by path alone
        (`src/audian/compresseddata.py:223-231`) and would serve the old
        overview after a re-export; the stamp closes that hole."""
        mtime, size = 0.0, 0
        for p in self.data.file_paths:
            try:
                st = os.stat(p)
            except OSError:
                continue
            mtime = max(mtime, st.st_mtime)
            size += st.st_size
        return mtime, size

    def save_data_local(self):
        """Persist next to the data file
        (`src/audian/compresseddata.py:147-155`)."""
        if self.short_data or self.datas is None or len(self.times) < 2:
            # < 2 samples covers the zero/near-zero-frame recording the
            # CLI force-persists (short_data=False): nothing to compress
            return None
        rate = 1.0 / (self.times[1] - self.times[0])
        path = self._local_path()
        # temp + rename: a killed writer (Ctrl-C'd compress CLI) must not
        # leave a truncated artifact that poisons every later open
        tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
        wavio.write_audio(tmp, self.datas, self._encode_rate(rate),
                          encoding="DOUBLE")
        os.replace(tmp, path)
        return path

    def save_data(self):
        """Persist into the JSON-indexed LRU user cache
        (`src/audian/compresseddata.py:157-202`)."""
        if self.short_data or self.datas is None or len(self.times) < 2:
            return None
        cache = Path(audian_dirs.user_cache_path)
        cache.mkdir(parents=True, exist_ok=True)
        index_path = cache / self.fulltraces_file
        # the whole read-modify-write runs under the cross-process lock:
        # two unlocked savers could pick the same free artifact name
        with _index_lock(cache):
            files = {}
            if index_path.exists():
                files = _read_index(index_path)
            first = os.fspath(Path(self.data.file_paths[0]).absolute())
            last = os.fspath(Path(self.data.file_paths[-1]).absolute())
            # re-saving the same recording updates its entry in place
            name = next((n for n, p in files.items()
                         if p["first"] == first and p["last"] == last),
                        None)
            if name is None:
                for k in range(1, self.max_files + 10):
                    name = f"{k:08X}-fulltrace.wav"
                    if name not in files:
                        break
            ts = datetime.now().isoformat()
            rate = 1.0 / (self.times[1] - self.times[0])
            # the stamp captured when the data was read, NOT now
            mtime, size = getattr(self, "_read_stamp", None) \
                or self._source_stamp()
            files[name] = dict(
                first=first, last=last, rate=rate,
                mtime=mtime, size=size,
                created=files.get(name, {}).get("created", ts), used=ts,
            )
            # LRU eviction by the `used` stamp
            if len(files) > self.max_files:
                order = sorted(files, key=lambda f: files[f]["used"])
                for f in order[: len(files) - self.max_files]:
                    try:
                        (cache / f).unlink()
                    except OSError:
                        pass
                    files.pop(f)
            # artifact first, atomically (temp + rename), THEN the index
            # — this save can run on a daemon thread that interpreter
            # shutdown kills mid-write, and an indexed truncated WAV
            # would poison every later open of this recording
            tmp = cache / (name + f".{os.getpid()}.tmp")
            wavio.write_audio(tmp, self.datas, self._encode_rate(rate),
                              encoding="DOUBLE")
            os.replace(tmp, cache / name)
            _write_index(index_path, files)
        return cache / name

    def load_data(self):
        """Cache lookup: local ``-fulltrace.wav`` first, then the user
        cache (stale entries evicted, ``used`` stamp refreshed) —
        `src/audian/compresseddata.py:204-248`."""
        self.times = None
        self.datas = None
        local = self._local_path()
        if local.exists():
            datas = None
            try:
                if local.stat().st_mtime >= self._source_stamp()[0]:
                    datas, rate = wavio.load_audio(local)
                # else: the recording changed after the artifact was
                # written (re-export/re-record) — stale; fall through to
                # the user cache, which validates its own stamp
            except Exception as e:
                # corrupt/truncated artifact (e.g. a pre-atomic-write
                # killed writer): fall through instead of making the
                # recording unopenable; the file is the user's, keep it
                print(f"ignoring corrupt {local.name}: {e}")
            if (datas is not None and datas.ndim == 2
                    and datas.shape[1] == self.data.channels):
                rates = np.array([rate / 1e6, rate / 1e3, rate])
                durations = len(datas) / rates
                rate = rates[np.argmin(
                    np.abs(durations - self.data.frames / self.data.rate))]
                self.datas = datas
                self.times = np.arange(len(datas)) / rate
                return True
        cache = Path(audian_dirs.user_cache_path)
        index_path = cache / self.fulltraces_file
        if not index_path.exists():
            return False
        files = _read_index(index_path)
        first = os.fspath(Path(self.data.file_paths[0]).absolute())
        last = os.fspath(Path(self.data.file_paths[-1]).absolute())
        for name, props in list(files.items()):
            if props["first"] == first and props["last"] == last:
                fpath = cache / name
                stamp = self._source_stamp()
                stale = ("mtime" in props
                         and (abs(props["mtime"] - stamp[0]) > 1e-6
                              or props.get("size") != stamp[1]))
                try:
                    datas, _ = (None, None) if stale \
                        else wavio.load_audio(fpath)
                except Exception:
                    # any decode failure means corrupt -> evict (WavError
                    # subclasses vary, soundfile raises RuntimeErrors)
                    datas = None
                if (datas is not None and len(datas)
                        and (datas.ndim != 2
                             or datas.shape[1] != self.data.channels)):
                    datas = None  # stale: channel layout changed
                if datas is None or len(datas) == 0:
                    with _index_lock(cache):
                        files = _read_index(index_path)
                        files.pop(name, None)
                        try:
                            fpath.unlink()
                        except OSError:
                            pass
                        _write_index(index_path, files)
                    return False
                self.datas = datas
                self.times = np.arange(len(datas)) / props["rate"]
                with _index_lock(cache):
                    files = _read_index(index_path)
                    if name in files:
                        files[name]["used"] = datetime.now().isoformat()
                        _write_index(index_path, files)
                return True
        return False


def _interleaved_minmax(buf, step):
    """Interleaved per-segment min/max; the ragged tail segment reduces
    separately (padding two full copies of a ~1 M-frame block to a step
    multiple cost ~16 MB of fresh pages per block on this host)."""
    n = len(buf)
    nseg = -(-n // step)
    out = np.empty((2 * nseg,) + buf.shape[1:])
    if nseg == 0:
        return out
    whole = n // step
    if whole:
        body = buf[: whole * step].reshape((whole, step) + buf.shape[1:])
        out[0 : 2 * whole : 2] = body.min(axis=1)
        out[1 : 2 * whole : 2] = body.max(axis=1)
    if whole < nseg:
        tail = buf[whole * step :]
        out[-2] = tail.min(axis=0)
        out[-1] = tail.max(axis=0)
    return out
