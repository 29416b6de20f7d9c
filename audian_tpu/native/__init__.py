"""ctypes bindings for the native host runtime (``wavio.cc``).

Builds the shared library on first use with the system compiler and falls
back to pure numpy when no compiler is available.  This is host-side code:
it feeds the device and serves the overview/cache path — the analog of the
compiled code the reference borrows from numpy/scipy/libsndfile (SURVEY.md
section 2, "Native / accelerated components").
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "libaudianative.so"
_SRC = _HERE / "wavio.cc"
_SRCS = [_HERE / "wavio.cc", _HERE / "flacdec.cc",
         _HERE / "flacenc.cc"]
_FFM_PATH = _HERE / "libaudianffm.so"
_FFM_SRC = _HERE / "ffflac.cc"
_lock = threading.Lock()
_lib = None
_tried = False
_ffm = None
_ffm_tried = False

_TAGS = {"PCM_16": (1, 16), "PCM_24": (1, 24), "PCM_32": (1, 32),
         "FLOAT": (3, 32), "DOUBLE": (3, 64)}


def _build():
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-march=native", "-shared",
        "-fPIC", "-pthread", *[str(s) for s in _SRCS],
        "-o", str(_LIB_PATH),
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib():
    """The loaded shared library, building it on demand; None when
    unavailable (callers fall back to numpy)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _LIB_PATH.exists() or any(
                s.stat().st_mtime > _LIB_PATH.stat().st_mtime
                for s in _SRCS
            ):
                _build()
            lib = ctypes.CDLL(str(_LIB_PATH))
        except Exception:
            return None
        lib.an_decode.restype = ctypes.c_int
        lib.an_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.an_read_frames.restype = ctypes.c_int64
        lib.an_read_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.an_minmax.restype = None
        lib.an_minmax.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.an_file_minmax.restype = ctypes.c_int
        lib.an_file_minmax.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.an_flac_encode.restype = ctypes.c_int64
        lib.an_flac_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.an_flac_decode_frame.restype = ctypes.c_int64
        lib.an_flac_decode_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available():
    return get_lib() is not None


def get_ffm():
    """The FFmpeg-backed FLAC oracle library (``ffflac.cc``), built on
    demand against the system libavcodec/libavformat; None when the
    FFmpeg development files are absent.  Validation-only — the
    production FLAC path never depends on it."""
    global _ffm, _ffm_tried
    with _lock:
        if _ffm is not None or _ffm_tried:
            return _ffm
        _ffm_tried = True
        try:
            if not _FFM_PATH.exists() or (
                _FFM_SRC.stat().st_mtime > _FFM_PATH.stat().st_mtime
            ):
                cmd = [
                    os.environ.get("CXX", "g++"), "-O2", "-shared",
                    "-fPIC", str(_FFM_SRC), "-o", str(_FFM_PATH),
                    "-lavcodec", "-lavformat", "-lavutil",
                ]
                subprocess.run(cmd, check=True, capture_output=True)
            lib = ctypes.CDLL(str(_FFM_PATH))
        except Exception:
            return None
        lib.ffp_audio_read.restype = ctypes.c_int
        lib.ffp_audio_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.ffp_audio_release.restype = None
        lib.ffp_audio_release.argtypes = [
            ctypes.POINTER(ctypes.c_float)]
        lib.ffp_flac_info.restype = ctypes.c_int
        lib.ffp_flac_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.ffp_flac_decode.restype = ctypes.c_longlong
        lib.ffp_flac_decode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong,
        ]
        lib.ffp_flac_encode.restype = ctypes.c_int
        lib.ffp_flac_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ffp_audio_encode.restype = ctypes.c_int
        lib.ffp_audio_encode.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p,
        ]
        _ffm = lib
        return _ffm


def ffm_available():
    return get_ffm() is not None


def ffm_probable():
    """Cheap availability probe for listing calls: True when the FFmpeg
    shim is loaded, already built on disk, or the system libraries are
    findable — WITHOUT triggering the on-demand g++ build (seconds;
    `available_formats` must not stall a dialog).
    The encode/decode paths still build lazily on first real use."""
    if _ffm is not None:
        return True
    if _ffm_tried:
        return False
    if _FFM_PATH.exists():
        return True
    import ctypes.util

    return ctypes.util.find_library("avformat") is not None


def ff_audio_decode(path):
    """Decode ANY container/codec the system FFmpeg libraries know
    (OGG/Vorbis, AIFF, MP3, ...) to ``(float32 (n, ch) in [-1, 1],
    rate)`` — the fallback reader for containers outside the in-repo
    WAV/FLAC decoders when ``soundfile`` is absent (the reference
    always has libsndfile, `/root/reference/pyproject.toml:17`).
    Returns None when the FFmpeg libraries are unavailable; raises
    ValueError when FFmpeg cannot decode the file."""
    lib = get_ffm()
    if lib is None:
        return None
    rate = ctypes.c_int()
    channels = ctypes.c_int()
    frames = ctypes.c_longlong()
    data = ctypes.POINTER(ctypes.c_float)()
    rc = lib.ffp_audio_read(str(path).encode(), ctypes.byref(data),
                            ctypes.byref(rate), ctypes.byref(channels),
                            ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={rc})")
    try:
        n = int(frames.value) * int(channels.value)
        if n == 0:
            out = np.zeros((0, max(int(channels.value), 1)), np.float32)
        else:
            out = np.ctypeslib.as_array(data, shape=(n,)).reshape(
                int(frames.value), int(channels.value)).copy()
    finally:
        lib.ffp_audio_release(data)
    return out, rate.value


def ff_flac_decode(path):
    """Decode a FLAC file through FFmpeg (independent oracle).  Returns
    ``(samples, rate, bits)`` with interleaved (n, ch) int32 raw sample
    values, or None when the oracle is unavailable.  Raises ValueError
    on decode failure (corrupt stream / CRC mismatch — FFmpeg runs with
    AV_EF_CRCCHECK|EXPLODE here)."""
    lib = get_ffm()
    if lib is None:
        return None
    rate = ctypes.c_int()
    channels = ctypes.c_int()
    bits = ctypes.c_int()
    frames = ctypes.c_longlong()
    rc = lib.ffp_flac_info(str(path).encode(), ctypes.byref(rate),
                           ctypes.byref(channels), ctypes.byref(bits),
                           ctypes.byref(frames))
    if rc != 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={rc})")
    out = np.empty((frames.value, channels.value), np.int32)
    got = lib.ffp_flac_decode(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(frames.value))
    if got < 0:
        raise ValueError(f"FFmpeg could not decode {path} (rc={got})")
    return out[: int(got)], rate.value, bits.value


def ff_flac_encode(path, samples, rate, bits=16, level=5):
    """Encode raw int samples (n, ch) at ``bits`` depth to ``path``
    through FFmpeg's FLAC encoder at compression ``level`` (0..12).
    Returns False when the oracle is unavailable; raises ValueError on
    encode failure."""
    lib = get_ffm()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.int32)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    rc = lib.ffp_flac_encode(
        str(path).encode(),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(frames), int(channels), int(rate), int(bits), int(level))
    if rc != 0:
        raise ValueError(f"FFmpeg could not encode {path} (rc={rc})")
    return True


#: format name -> FFmpeg muxer name for :func:`ff_audio_encode` (the
#: formats the save dialogs list when the FFmpeg libraries are present)
FF_EXPORT_FORMATS = {"OGG": "ogg", "AIFF": "aiff", "MP3": "mp3",
                     "OPUS": "opus"}


def ff_audio_encode(path, samples, rate, format=None, metadata=None):
    """Encode float samples (``(n, ch)`` in [-1, 1]) into any container
    the system FFmpeg can mux — the write-side twin of
    :func:`ff_audio_decode` (OGG/Vorbis, AIFF, MP3, Opus...).  The
    reference's save dialog offers every ``datawriter`` format
    (`/root/reference/src/audian/databrowser.py:1875-1880`); this is how
    audian-tpu reaches the same breadth beyond its native WAV/RF64/FLAC
    writers.  ``format`` is a :data:`FF_EXPORT_FORMATS` key or an
    FFmpeg muxer name; None guesses from the file suffix.  ``metadata``
    (a flat or nested dict) lands in the muxer's tag dictionary (vorbis
    comments, ID3, ...) — formats store what they support, like
    libsndfile does for the reference.  Returns False when the FFmpeg
    libraries are unavailable; raises ValueError on encode failure
    (unsupported rate/codec, unwritable path)."""
    lib = get_ffm()
    if lib is None:
        return False
    samples = np.ascontiguousarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    frames, channels = samples.shape
    fmt = FF_EXPORT_FORMATS.get((format or "").upper(), format or "")

    def clean(s):
        # records are 0x1E-separated on the wire so multi-line values
        # (legal in BWF/INFO comments) survive intact; only the
        # separator itself must not appear inside a key or value
        return str(s).replace("\x1e", " ")

    kv = []
    for key, val in (metadata or {}).items():
        if isinstance(val, dict):  # nested (e.g. BEXT): dotted keys
            kv += [f"{clean(key)}.{clean(k2)}={clean(v2)}"
                   for k2, v2 in val.items()
                   if not isinstance(v2, dict)]
        else:
            kv.append(f"{clean(key)}={clean(val)}")
    rc = lib.ffp_audio_encode(
        str(path).encode(),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(frames), int(channels), int(round(float(rate))),
        fmt.encode(), "\x1e".join(kv).encode("utf-8", "replace"))
    if rc != 0:
        raise ValueError(
            f"FFmpeg could not encode {path} as {fmt or 'auto'} "
            f"(rc={rc}; lossy codecs constrain rates/channels)")
    return True


def read_frames(path, data_off, encoding, channels, start, nframes,
                out=None):
    """Native read+decode of a frame range to float32; None when the native
    path is unavailable or the encoding unsupported.

    ``out`` (optional) receives the frames in place — pass a recycled
    (nframes, channels) float32 C-contiguous array to avoid fresh-page
    allocation costs on hot read paths; the return value is a view of it.
    """
    lib = get_lib()
    tb = _TAGS.get(encoding)
    if lib is None or tb is None:
        return None
    if out is None:
        out = np.empty((nframes, channels), np.float32)
    else:
        if (out.dtype != np.float32 or out.shape != (nframes, channels)
                or not out.flags.c_contiguous):
            raise ValueError("out must be C-contiguous float32 "
                             f"of shape {(nframes, channels)}")
    got = lib.an_read_frames(
        str(path).encode(), int(data_off), tb[0], tb[1], int(channels),
        int(start), int(nframes),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got < 0:
        return None
    return out[:got]


def flac_encode(samples, rate, bits, blocksize=4096, max_lpc_order=8):
    """Encode raw int codes (n, ch) to a complete FLAC stream (bytes)
    through the C++ encoder (``flacenc.cc`` — the production write
    path; the Python encoder in ``data/flac.py`` is the readable
    reference and fallback).  Returns None when the native library is
    unavailable or rejects the geometry."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(samples, np.int32)
    frames, channels = q.shape
    cap = frames * channels * (bits // 8 + 2) + (1 << 17)
    out = np.empty(cap, np.uint8)
    got = lib.an_flac_encode(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(frames), int(channels), int(round(float(rate))), int(bits),
        int(blocksize), int(max_lpc_order),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(cap))
    if got < 0:
        return None
    return out[:got].tobytes()


def flac_decode_frame(buf, offset, sinfo):
    """Decode one FLAC frame at byte ``offset`` of ``buf`` (the whole
    stream) — the hot loop of :mod:`audian_tpu.data.flac`.  Returns the
    ``(blocksize, channels)`` int32 samples, or None when the native
    library is unavailable or rejects the frame (the caller falls back
    to the Python reference decoder)."""
    got = flac_decode_frame_meta(buf, offset, sinfo)
    return None if got is None else got[0]


def flac_decode_frame_meta(buf, offset, sinfo):
    """Like :func:`flac_decode_frame` but returns
    ``(samples, position, end)`` — the frame's first-sample index from
    its coded number and the byte offset just past its CRC-16.  The
    lazy frame index (`data/flac.py:_FlacFile`) chains frames through
    ``end`` instead of sync-scanning the whole file."""
    lib = get_lib()
    if lib is None:
        return None
    channels = int(sinfo["channels"])
    maxbs = int(sinfo["max_blocksize"])
    out = np.empty((maxbs, channels), np.int32)
    work = np.empty(3 * maxbs, np.int64)
    meta = np.empty(2, np.int64)
    # buf may be bytes or an mmap (the loader maps FLAC files so decode
    # pages lazily); view it zero-copy and pass the raw pointer
    view = np.frombuffer(buf, np.uint8)
    n = lib.an_flac_decode_frame(
        view.ctypes.data_as(ctypes.c_void_p), len(buf), int(offset),
        int(sinfo["rate"]), channels,
        int(sinfo["bits"]), int(sinfo["min_blocksize"]), maxbs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        work.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        return None
    return out[:n], int(meta[0]), int(meta[1])


def minmax(x, step):
    """Interleaved min/max decimation of an (n, channels) float32 array;
    None when the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    frames, channels = x.shape
    nseg = -(-frames // step)
    out = np.empty((2 * nseg, channels), np.float64)
    lib.an_minmax(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, channels, int(step),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def file_minmax(path, data_off, encoding, channels, frames, step,
                nthreads=None, start=0):
    """Threaded min/max overview of ``frames`` frames from frame
    ``start`` (the reference's `down_sample_worker` pool,
    `src/audian/compresseddata.py:25-53`, as lock-free C++ threads).
    Returns (2*nseg, channels) float64 or None.  ``start`` lets callers
    slice a huge file into cancellable pieces — fixed-size PCM frames
    make it a pure data-offset shift."""
    lib = get_lib()
    tb = _TAGS.get(encoding)
    if lib is None or tb is None:
        return None
    if nthreads is None:
        nthreads = max(1, (os.cpu_count() or 2) - 1)
    nseg = -(-frames // step)
    out = np.zeros((2 * nseg, channels), np.float64)
    rc = lib.an_file_minmax(
        str(path).encode(),
        int(data_off) + int(start) * channels * (tb[1] // 8),
        tb[0], tb[1], int(channels),
        int(frames), int(step), int(nthreads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        return None
    return out
