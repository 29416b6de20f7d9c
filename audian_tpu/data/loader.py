"""Out-of-core audio loading with a sliding buffer window.

Replaces the audioio/thunderlab ``DataLoader``/``BufferedArray`` stack the
reference builds on (`src/audian/data.py:9,172`): a windowed view over one
or more (concatenated) WAV files that keeps only ``buffer_time`` seconds in
memory with ``back_time`` seconds retained behind the cursor
(`src/audian/data.py:17-18,168-174`), loading frames on demand.

The loader is host-side by design — file decode feeds the device through
chunk windows.  Bulk decode can go through the C++ fast path in
:mod:`audian_tpu.native` when built.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from . import wavio
from .. import native
from ..utils import trace as _trace


class _RawReader:
    """Prefetcher-facing view of a loader's direct read path (the
    prefetcher caches ON TOP of the file reads, below the window)."""

    def __init__(self, loader):
        self._loader = loader

    @property
    def frames(self):
        return self._loader.frames

    @property
    def channels(self):
        return self._loader.channels

    @property
    def dtype(self):
        return self._loader.dtype

    def _read(self, start, nframes, out=None):
        return self._loader._read_direct(start, nframes, out=out)


class AudioLoader:
    """Windowed, multi-file, unwrap-capable audio source.

    API surface matches what the reference consumes from audioio's
    ``DataLoader``: ``rate, channels, frames, shape, offset, buffer,
    bufferframes, backframes, follow, buffer_changed, unit, ampl_min,
    ampl_max, encoding, file_paths, filepath, end_indices``, methods
    ``update_time, load_buffer, __getitem__, __len__, metadata, markers,
    format_dict, set_unwrap, get_file_index, basename, close``.
    """

    def __init__(self, file_paths, buffer_time=60.0, back_time=20.0,
                 verbose=0, rate=None, channels=None, unit=None,
                 amax=None, end_indices=None, dtype=np.float32,
                 prefetch=True):
        if isinstance(file_paths, (str, Path)):
            file_paths = [file_paths]
        self.file_paths = [Path(p) for p in file_paths]
        if not self.file_paths:
            raise ValueError("no files")
        self.verbose = verbose
        self.dtype = np.dtype(dtype)
        self._infos = [wavio.wav_info(p) for p in self.file_paths]
        rates = {i[0] for i in self._infos}
        chans = {i[1] for i in self._infos}
        if len(rates) > 1 or len(chans) > 1:
            raise ValueError(
                f"files disagree in rate/channels: rates={sorted(rates)}, "
                f"channels={sorted(chans)}"
            )
        self.rate = rate or self._infos[0][0]
        self.channels = channels or self._infos[0][1]
        self.encoding = self._infos[0][3]
        if end_indices is not None:
            self.end_indices = np.asarray(end_indices, dtype=np.int64)
        else:
            self.end_indices = np.cumsum([i[2] for i in self._infos])
        self.frames = int(self.end_indices[-1])
        self.shape = (self.frames, self.channels)
        self.ndim = 2
        self.size = self.frames * self.channels
        self.unit = unit or "a.u."
        self.ampl_min = -(amax or 1.0)
        self.ampl_max = amax or 1.0
        self.filepath = self.file_paths[0]
        # windowed buffer state
        self.bufferframes = int(buffer_time * self.rate)
        self.backframes = int(back_time * self.rate)
        self.follow = 0
        self.offset = 0
        self.buffer = np.zeros((0, self.channels), self.dtype)
        #: retired window storage, recycled by the next same-shape
        #: move_buffer (views returned by __getitem__ are only valid
        #: until the second following buffer move, as in audioio's
        #: in-place BufferedArray)
        self._spare = None
        self.buffer_changed = np.zeros(self.channels, dtype=bool)
        # unwrap config (reference CLI -u/-U, audian.py:1485-1490)
        self.unwrap_thresh = 0.0
        self.unwrap_clips = False
        # background read-ahead (audian_tpu.stream), on by default: the
        # interactive scroll path and the batch CLIs both overlap disk
        # decode with compute through it
        self._prefetcher = None
        if prefetch:
            from ..stream import BlockPrefetcher

            self._prefetcher = BlockPrefetcher(_RawReader(self))
        if verbose:
            for p, info in zip(self.file_paths, self._infos):
                print(f"opened {p} ({info[2]} frames @ {info[0]:.0f} Hz)")

    # -- identity / metadata ---------------------------------------------------

    def __len__(self):
        return self.frames

    def metadata(self):
        return wavio.metadata(self.file_paths[0])

    def markers(self):
        locs_all, labels_all = [], []
        start = 0
        for k, p in enumerate(self.file_paths):
            locs, labels = wavio.markers(p)
            if len(locs):
                locs = locs.copy()
                locs[:, 0] += start
                locs_all.append(locs)
                labels_all.append(labels)
            start = int(self.end_indices[k])
        if locs_all:
            return np.concatenate(locs_all), np.concatenate(labels_all)
        return (np.zeros((0, 2), dtype=np.int64),
                np.zeros((0, 2), dtype=object))

    def format_dict(self):
        fmt = ("WAV" if self._infos[0][4] is not None
               else self.filepath.suffix.upper().lstrip(".") or "AUDIO")
        return dict(format=fmt, encoding=self.encoding,
                    rate=f"{self.rate:.0f}Hz", channels=str(self.channels),
                    frames=str(self.frames),
                    duration=f"{self.frames / self.rate:.3f}s")

    def file_start_times(self):
        """Start time in seconds of each file within the concatenated
        recording — feeds the per-file time-axis mode
        (`src/audian/timeaxisitem.py:20-26` FILE_TIME)."""
        starts = np.concatenate([[0], self.end_indices[:-1]])
        return starts / self.rate

    def get_file_index(self, index):
        """(file_path, frame index within that file) for a global frame
        (`src/audian/data.py:233-236` consumes this for per-file time
        display)."""
        index = min(max(int(index), 0), self.frames - 1)
        k = int(np.searchsorted(self.end_indices, index, side="right"))
        start = 0 if k == 0 else int(self.end_indices[k - 1])
        return self.file_paths[k], index - start

    def basename(self, path=None):
        return Path(path if path is not None else self.filepath).name

    def set_unwrap(self, thresh, clips=False, down_scale=False, unit=""):
        """``down_scale``/``unit`` are accepted for audioio signature
        parity only: with ``clips=False`` this loader always scales the
        unwrapped data down by two (the reference CLI's ``-u`` semantic,
        `src/audian/audian.py:1485-1490`), so the amplitude range —
        and hence ``ampl_max`` — never changes."""
        self.unwrap_thresh = float(thresh)
        self.unwrap_clips = bool(clips)
        if self._prefetcher is not None:
            # cached blocks were decoded with the previous unwrap config
            self._prefetcher.invalidate()
        return self

    def close(self):
        if self._prefetcher is not None:
            self._prefetcher.close()
        self.buffer = np.zeros((0, self.channels), self.dtype)
        self._spare = None

    # -- raw reads ----------------------------------------------------------------

    def _read(self, start, nframes):
        """Read [start, start+nframes) across file boundaries, through the
        read-ahead cache when enabled."""
        if self._prefetcher is not None:
            return self._prefetcher.read(start, nframes)
        return self._read_direct(start, nframes)

    def _read_into(self, start, nframes, out):
        """Fill ``out`` (a (nframes, channels) array) with frames
        [start, start+nframes) — the recycled-buffer read path: no fresh
        allocation, and multi-block prefetcher reads skip the concatenate
        that ``_read`` pays."""
        if self._prefetcher is not None:
            self._prefetcher.read_into(start, nframes, out)
        else:
            self._read_direct(start, nframes, out=out)
        return out

    def _read_direct(self, start, nframes, out=None):
        start = max(0, min(int(start), self.frames))
        nframes = max(0, min(int(nframes), self.frames - start))
        if self.unwrap_thresh > 1e-3 and start > 0 and nframes > 0:
            # one sample of left context seeds the wrap detection at the
            # chunk boundary (a jump between start-1 and start would
            # otherwise be invisible to this read's diff)
            ext = self._read_raw(start - 1, nframes + 1)
            ext = wavio.unwrap(ext, self.unwrap_thresh, self.unwrap_clips,
                               self.ampl_max).astype(self.dtype)
            if out is not None:
                out[:nframes] = ext[1:]
                return out[:nframes]
            return np.ascontiguousarray(ext[1:])
        if out is not None:
            self._read_raw(start, nframes, out=out)
            data = out[:nframes]
        else:
            data = self._read_raw(start, nframes)
        if self.unwrap_thresh > 1e-3:
            unwrapped = wavio.unwrap(data, self.unwrap_thresh,
                                     self.unwrap_clips,
                                     self.ampl_max).astype(self.dtype)
            if out is not None:
                data[:] = unwrapped
                return data
            return unwrapped
        return data

    def _read_raw(self, start, nframes, out=None):
        _trace.trace_event("loader.read", start=start, frames=nframes)
        if out is None:
            out = np.empty((nframes, self.channels), self.dtype)
        pos = 0
        while pos < nframes:
            g = start + pos
            k = int(np.searchsorted(self.end_indices, g, side="right"))
            fstart = 0 if k == 0 else int(self.end_indices[k - 1])
            local = g - fstart
            avail = int(self.end_indices[k]) - g
            n = min(nframes - pos, avail)
            info = self._infos[k]
            dst = out[pos : pos + n]
            chunk = None
            if (self.dtype == np.float32 and info[4] is not None
                    and dst.flags.c_contiguous):
                # native C++ read+decode fast path straight into the
                # output (WAV only; soundfile-backed containers have no
                # byte offset to seek to)
                chunk = native.read_frames(self.file_paths[k], info[4],
                                           info[3], info[1], local, n,
                                           out=dst)
                if chunk is not None:
                    m = len(chunk)
                    if m < n:  # file shorter than header claims
                        dst[m:] = 0.0
                    pos += n
                    continue
            chunk = wavio.read_frames(self.file_paths[k], local, n, info)
            m = min(len(chunk), n)
            dst[:m] = chunk[:m]
            if m < n:  # file shorter than header claims: zero-fill
                dst[m:] = 0.0
            pos += n
        return out

    @property
    def raw16_capable(self):
        """True when :meth:`read_raw16_into` can serve reads: every file
        stores 16-bit codes readable without a float pass — a PCM-16 WAV
        with a seekable data chunk, or a 16-bit FLAC (the native decoder
        emits the quantized codes directly) — and unwrapping is off
        (unwrap rescales samples, so raw quantized values would be
        wrong)."""
        return (self.unwrap_thresh <= 1e-3
                and all((i[3] == "PCM_16" and i[4] is not None)
                        or i[3] == "FLAC_16"
                        for i in self._infos))

    def read_raw16_into(self, start, nframes, out):
        """Fill ``out`` (C-contiguous ``(>=nframes, channels)`` int16)
        with the raw quantized PCM-16 samples of [start, start+nframes).

        Device int16 upload paths (``Data._put_raw``, ``bench.py``)
        dequantize as ``k / 2**15`` — exactly how :func:`wavio.
        read_frames` decodes PCM-16 — so skipping the float decode and
        re-quantization is bit-exact and saves several full passes over
        the data on the host.  Bypasses the block prefetcher (this is the
        batch-sequential path; the OS page cache covers re-reads).
        Check :attr:`raw16_capable` first.
        """
        if not self.raw16_capable:
            raise wavio.WavError("raw16 reads need all-PCM-16-WAV or "
                                 "16-bit-FLAC sources without unwrap")
        _trace.trace_event("loader.read_raw16", start=start,
                           frames=nframes)
        start = max(0, min(int(start), self.frames))
        nframes = max(0, min(int(nframes), self.frames - start))
        pos = 0
        while pos < nframes:
            g = start + pos
            k = int(np.searchsorted(self.end_indices, g, side="right"))
            fstart = 0 if k == 0 else int(self.end_indices[k - 1])
            local = g - fstart
            avail = int(self.end_indices[k]) - g
            n = min(nframes - pos, avail)
            dst = out[pos : pos + n]
            m = wavio.read_frames_raw16(self.file_paths[k], local, n,
                                        self._infos[k], dst)
            if m < n:  # file shorter than header claims: zero-fill
                dst[m:] = 0
            pos += n
        return out[:nframes]

    def load_buffer(self, offset, nframes, buffer):
        """Fill ``buffer`` with frames [offset, offset+nframes) — the
        worker-side API of the reference's decimation pipeline
        (`src/audian/compresseddata.py:47`)."""
        buffer[:] = self._read(offset, nframes)

    # -- windowed buffer ------------------------------------------------------------

    #: buffer offsets snap to this grid so downstream chunk geometry (and
    #: therefore compiled XLA programs) recur across scroll positions
    align = 1 << 12

    def update_time(self, t0, t1):
        """Ensure [t0, t1) (seconds) is in the buffer, retaining
        ``back_time`` behind t0 (`src/audian/data.py:225-236` driver).

        The window is placed on an aligned grid with a *fixed* length
        (``bufferframes``, or the next power of two of the requested span
        when larger), so interior scrolling always produces the same chunk
        shape — one compiled program instead of one per scroll position.
        """
        i0 = max(0, int(math.floor(t0 * self.rate)) - self.backframes)
        # ``follow`` extends the window ahead of the request (audioio's
        # BufferedArray semantic; the reference sets it through
        # Data.follow_time, `src/audian/data.py:19,181`)
        i1 = min(self.frames,
                 int(math.ceil(t1 * self.rate)) + max(self.follow, 0))
        span = max(i1 - i0, 0)
        # a zero-frame budget (buffer_time*rate < 1) must still grow to
        # cover the request — n*=2 from 0 would loop forever
        n = max(self.bufferframes, self.align, 1)
        while n < span + self.align:
            n *= 2
        i0 = (i0 // self.align) * self.align
        if i0 + n > self.frames:
            i0 = max(0, ((self.frames - n) // self.align) * self.align)
        n = min(n, self.frames - i0)
        self.move_buffer(i0, n)

    def move_buffer(self, offset, nframes):
        offset = max(0, min(int(offset), self.frames))
        nframes = max(0, min(int(nframes), self.frames - offset))
        if offset >= self.offset and offset + nframes <= self.offset + len(self.buffer):
            return  # already covered
        # recycle the previous window's storage (first touch of fresh
        # pages costs a page fault per page); the outgoing buffer becomes the next move's spare, so steady-state
        # scrolling ping-pongs between two warm buffers
        spare = self._spare
        if spare is not None and spare.shape == (nframes, self.channels):
            new, self._spare = spare, None
        else:
            new = np.empty((nframes, self.channels), self.dtype)
        # reuse overlap with the current buffer
        o0 = max(offset, self.offset)
        o1 = min(offset + nframes, self.offset + len(self.buffer))
        if o1 > o0:
            new[o0 - offset : o1 - offset] = self.buffer[
                o0 - self.offset : o1 - self.offset]
            if o0 > offset:
                self._read_into(offset, o0 - offset, new[: o0 - offset])
            if o1 < offset + nframes:
                self._read_into(o1, offset + nframes - o1,
                                new[o1 - offset :])
        else:
            self._read_into(offset, nframes, new)
        if len(self.buffer):
            self._spare = self.buffer
        self.offset = offset
        self.buffer = new
        self.buffer_changed[:] = True

    def __getitem__(self, key):
        """Serve any index — from the buffer when covered, else straight
        from disk (without disturbing the window)."""
        if isinstance(key, tuple):
            frame_key, rest = key[0], key[1:]
        else:
            frame_key, rest = key, ()
        if isinstance(frame_key, slice):
            start, stop, step = frame_key.indices(self.frames)
            if step < 0:
                # normalize to a forward read then stride backwards over
                # it: the forward formulas would compute 0 frames for the
                # disk path, and stop=-1 (a reversed slice reaching frame
                # 0) would be re-interpreted as end-relative by numpy
                lo, hi = stop + 1, start + 1
                n = max(hi - lo, 0)
                if (n and lo >= self.offset
                        and hi <= self.offset + len(self.buffer)):
                    fwd = self.buffer[lo - self.offset : hi - self.offset]
                else:
                    fwd = self._read(lo, n)
                data = fwd[start - lo :: step] if n else fwd
            elif (start >= self.offset
                    and stop <= self.offset + len(self.buffer)):
                data = self.buffer[start - self.offset
                                   : stop - self.offset : step]
            else:
                data = self._read(start, max(stop - start, 0))[::step]
            return data[(slice(None),) + rest] if rest else data
        idx = int(frame_key)
        if idx < 0:
            idx += self.frames
        if self.offset <= idx < self.offset + len(self.buffer):
            row = self.buffer[idx - self.offset]
        else:
            row = self._read(idx, 1)[0]
        return row[rest] if rest else row
