"""WAV file I/O with metadata and markers.

Self-contained replacement for the audioio functions the reference relies
on (`load_audio`, `write_audio`, `metadata`, `markers`, `get_datetime`,
`update_starttime`, `bext_history_str`, `add_history`, `unwrap` — see
`src/audian/databrowser.py:23-26`, `src/audian/compresseddata.py:17-19`).
Pure numpy/stdlib on the host (file decode is host work; the device consumes
chunk windows).  A C++ fast path for bulk PCM decode + min/max pyramids
lives in :mod:`audian_tpu.native`.

Supported encodings: PCM_16, PCM_24, PCM_32, FLOAT, DOUBLE (DOUBLE is what
the fulltrace pyramid cache uses, `src/audian/compresseddata.py:151-155`).
Metadata: RIFF LIST-INFO tags and the broadcast-wave ``bext`` chunk
(incl. CodingHistory).  Markers: ``cue`` chunk plus LIST-adtl ``labl`` /
``note`` / ``ltxt`` entries, exposed as ``(locs (n,2) [pos, span],
labels (n,2) [label, text])`` arrays — the audioio convention the
reference consumes at `src/audian/databrowser.py:318-319`.
"""

from __future__ import annotations

import datetime as dt
import struct
import sys
from pathlib import Path

import numpy as np

__all__ = [
    "load_audio",
    "write_audio",
    "WavWriter",
    "metadata",
    "markers",
    "load_wav",
    "get_datetime",
    "update_starttime",
    "bext_history_str",
    "add_history",
    "unwrap",
    "available_formats",
    "available_encodings",
]


_ENCODINGS = {
    "PCM_16": (1, 16),
    "PCM_24": (1, 24),
    "PCM_32": (1, 32),
    "PCM_U8": (1, 8),  # WAV 8-bit is unsigned with a 128 offset
    "FLOAT": (3, 32),
    "DOUBLE": (3, 64),
}

_INFO_TAGS = {
    "INAM": "Title", "IART": "Artist", "ICMT": "Comment", "ICRD": "Date",
    "IENG": "Engineer", "IGNR": "Genre", "IKEY": "Keywords",
    "IPRD": "Product", "ISFT": "Software", "ISRC": "Source",
    "ICOP": "Copyright", "ISBJ": "Subject",
}
_INFO_TAGS_INV = {v: k for k, v in _INFO_TAGS.items()}

_BEXT_FIELDS = [
    ("Description", 256), ("Originator", 32), ("OriginatorReference", 32),
    ("OriginationDate", 10), ("OriginationTime", 8),
]


def available_formats():
    # WAV, RF64 and FLAC write natively (this module + data/flac.py);
    # the system FFmpeg libraries add OGG/AIFF/MP3/... export (the
    # reference's save dialog breadth comes from libsndfile the same
    # way, `src/audian/databrowser.py:1875-1880`), and soundfile widens
    # the set to everything libsndfile knows
    base = ["WAV", "FLAC", "RF64"]
    from .. import native

    if native.ffm_probable():  # cheap: never triggers the g++ build
        base += sorted(native.FF_EXPORT_FORMATS)
    sf = _soundfile()
    if sf is not None:
        base += sorted(f for f in sf.available_formats()
                       if f not in base)
    return base


def available_encodings(format="WAV"):
    if (format or "").upper() == "FLAC":
        return ["PCM_16", "PCM_24", "PCM_32"]  # FLAC is integer-only
    return list(_ENCODINGS)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class WavError(ValueError):
    pass


_SF = 0  # 0 = untried, None = unavailable, module otherwise


def _soundfile():
    """The optional ``soundfile`` (libsndfile) package, or None.

    The reference reads every container audioio/libsndfile knows
    (`pyproject.toml:17`); the in-repo reader covers WAV (with the C++
    fast path), and other formats (FLAC, OGG, ...) are delegated to
    soundfile when it is installed.  Soundfile-backed files are marked by
    a ``None`` data offset in their info tuple.
    """
    global _SF
    if _SF == 0:
        try:
            import soundfile

            _SF = soundfile
        except ImportError:
            _SF = None
    return _SF


def _sf_unavailable(path):
    return WavError(
        f"{path}: not a RIFF/WAVE or FLAC file (WAV and FLAC decode "
        "natively; other containers need the 'soundfile' package or "
        "the system FFmpeg libraries)")


_FF_CACHE = {}  # (path, mtime, size) -> (float32 samples, rate)
_FF_CACHE_BYTES = 1 << 30


def _ff_decode_cached(p):
    """Whole-file decode of a non-WAV/FLAC container through the system
    FFmpeg libraries (``native.ff_audio_decode``), LRU-cached so the
    loader's windowed reads do not re-decode — the fallback matching
    the reference's always-present libsndfile when ``soundfile`` is not
    installed.  Returns None when FFmpeg is unavailable or cannot read
    the file (callers fall through to their own error)."""
    try:
        st = p.stat()
    except OSError:
        return None
    key = (str(p), st.st_mtime_ns, st.st_size)
    hit = _FF_CACHE.get(key)
    if hit is None:
        from .. import native

        try:
            hit = native.ff_audio_decode(p)
        except OSError:
            return None
        except ValueError as e:
            # FFmpeg was present and TRIED: surface the real decode
            # failure instead of the misleading "install soundfile" hint
            # callers emit for a None return
            raise WavError(f"{p}: FFmpeg failed to decode: {e}") from e
        if hit is None:
            return None
        # bound entries AND bytes: a few multi-GB decodes must not pin
        # host RAM (libsndfile seek-reads have no such cost; this
        # fallback trades memory for dependency-freedom).  A single
        # over-cap decode is served uncached — inserting it would pin it
        # until the next miss on this low-RAM host.
        if hit[0].nbytes > _FF_CACHE_BYTES:
            return hit
        total = sum(v[0].nbytes for v in _FF_CACHE.values())
        if len(_FF_CACHE) > 4 or total + hit[0].nbytes > _FF_CACHE_BYTES:
            _FF_CACHE.clear()
        _FF_CACHE[key] = hit
    return hit


# -- large-file WAVE containers (RF64 / BW64 / W64) --------------------------
#
# Standard RIFF caps every chunk size at 32 bits, so a recording dies at
# 4 GiB — the repo's own headline workload (1 h x 16 ch x 96 kHz int16)
# is 11 GB.  Field recorders switch to RF64 (EBU tech 3306: a ``ds64``
# chunk carries 64-bit riff/data sizes; BW64 is its EBU successor with
# the same layout) or Sony Wave64 (16-byte GUID chunk ids + 64-bit
# header-inclusive sizes, 8-byte alignment).  The reference reads all of
# them for free through libsndfile (`/root/reference/pyproject.toml:17`);
# here one chunk walker feeds the same windowed loader, so a >4 GB file
# opens in O(header) without ever materializing the payload.

_W64_SUFFIX = bytes.fromhex("f3acd3118cd100c04f8edb8a")
_W64_RIFF_GUID = b"riff" + bytes.fromhex("2e91cf11a5d628db04c10000")
_W64_WAVE_GUID = b"wave" + _W64_SUFFIX
# metadata bodies are read whole; cap them so a corrupt 64-bit size
# cannot ask for a multi-GB allocation (real fmt/LIST/bext are tiny)
_META_CHUNK_CAP = 1 << 26
# largest RIFF form size a 32-bit header can express; past this the
# writers promote to RF64 (module-level so tests can exercise the
# promotion on small files)
_RIFF_MAX = 0xFFFFFFFE


def _wave_container(head):
    """Container kind from the first 16 file bytes: ``"riff"`` (RIFF /
    RF64 / BW64 little-endian WAVE family) or ``"w64"``, else None."""
    if head[:4] in (b"RIFF", b"RF64", b"BW64") and head[8:12] == b"WAVE":
        return "riff"
    if head[:16] == _W64_RIFF_GUID:
        return "w64"
    return None


def _parse_ds64(body, path):
    """Chunk-id -> 64-bit size overrides from an RF64 ``ds64`` body."""
    if len(body) < 28:
        raise WavError(f"{path}: ds64 chunk truncated")
    _riff_sz, data_sz, _samples = struct.unpack_from("<QQQ", body, 0)
    sizes = {b"data": data_sz}
    (tn,) = struct.unpack_from("<I", body, 24)
    for k in range(tn):
        base = 28 + 12 * k
        if base + 12 > len(body):
            break  # truncated table: keep what parsed
        (tsz,) = struct.unpack_from("<Q", body, base + 4)
        sizes[bytes(body[base : base + 4])] = tsz
    return sizes


def _walk_wave_chunks(f, path):
    """Yield ``(cid, size, body_offset)`` for each chunk of an open
    RIFF / RF64 / BW64 / W64 WAVE file.

    Sizes are true 64-bit byte counts: RF64's ``ds64`` overrides are
    applied to the ``0xFFFFFFFF`` placeholders, and W64's
    header-inclusive GUID-chunk sizes are normalized to body bytes.  The
    file is positioned at ``body_offset`` when a chunk is yielded (so
    callers may read the body); the walker reseeks from the recorded
    offset afterwards.  A plain-RIFF ``data`` size of ``0xFFFFFFFF``
    (a streamed write that never got patched) is passed through for the
    callers' clamp-by-file-size handling.
    """
    f.seek(0)
    head = f.read(16)
    kind = _wave_container(head)
    if kind == "w64":
        rest = f.read(24)  # 64-bit riff size + the wave GUID
        if len(rest) < 24 or rest[8:24] != _W64_WAVE_GUID:
            raise WavError(f"{path}: not a W64 WAVE file")
        while True:
            hdr = f.read(24)
            if len(hdr) < 24:
                break
            (size,) = struct.unpack("<Q", hdr[16:24])
            if size < 24:
                raise WavError(f"{path}: invalid W64 chunk size {size}")
            body = size - 24
            off = f.tell()
            yield bytes(hdr[:4]), body, off
            f.seek(off + ((body + 7) & ~7))  # 8-byte alignment
        return
    if kind is None:
        raise WavError(f"{path}: not a RIFF/WAVE file")
    f.seek(12)
    ds64 = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid = bytes(hdr[:4])
        (size,) = struct.unpack("<I", hdr[4:])
        if cid == b"ds64":
            body = f.read(size + (size & 1))
            ds64 = _parse_ds64(body, path)
            continue
        if size == 0xFFFFFFFF and ds64 is not None and cid in ds64:
            size = ds64[cid]
        off = f.tell()
        yield cid, size, off
        f.seek(off + size + (size & 1))


def _parse_fmt(buf, off, size):
    """Parse and VALIDATE a fmt chunk — malformed headers must raise
    :class:`WavError`, not leak struct/ZeroDivision errors into callers
    (zero channels would divide frame math by zero everywhere)."""
    if size < 16 or off + 16 > len(buf):
        raise WavError("fmt chunk truncated")
    tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", buf, off)
    if tag == 0xFFFE and size >= 40 and off + 26 <= len(buf):
        (tag,) = struct.unpack_from("<H", buf, off + 24)  # EXTENSIBLE
    if channels < 1:
        raise WavError(f"invalid channel count: {channels}")
    if rate <= 0:
        raise WavError(f"invalid sample rate: {rate}")
    if bits < 8:
        raise WavError(f"invalid bit depth: {bits}")
    return tag, channels, rate, bits


def _decode(raw, tag, bits, channels):
    # clamp truncated payloads to whole samples: np.frombuffer raises a
    # bare ValueError on partial trailing bytes
    bps = max(bits // 8, 1)
    if len(raw) % bps:
        raw = raw[: len(raw) - (len(raw) % bps)]
    if tag == 3:
        dtype = np.float32 if bits == 32 else np.float64
        data = np.frombuffer(raw, dtype="<f4" if bits == 32 else "<f8")
        data = data.astype(dtype, copy=False)
    elif tag == 1:
        if bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 2 ** 15
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2 ** 31
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            data = ints.astype(np.float64) / 2 ** 23
        elif bits == 8:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64)
                    - 128.0) / 128.0
        else:
            raise WavError(f"unsupported PCM bit depth: {bits}")
    else:
        raise WavError(f"unsupported WAV format tag: {tag}")
    frames = len(data) // channels
    return data[: frames * channels].reshape(frames, channels)


def _cstr(b):
    return b.split(b"\x00", 1)[0].decode("latin-1", "replace").strip()


def _parse_bext(buf, off, size):
    md = {}
    pos = off
    for name, n in _BEXT_FIELDS:
        md[name] = _cstr(buf[pos : pos + n])
        pos += n
    lo, hi = struct.unpack_from("<II", buf, pos)
    md["TimeReference"] = (hi << 32) | lo
    pos += 8
    (md["Version"],) = struct.unpack_from("<H", buf, pos)
    pos += 2
    pos += 64  # UMID
    pos += 10  # loudness
    pos += 180  # reserved
    if pos < off + size:
        md["CodingHistory"] = _cstr(buf[pos : off + size])
    return {k: v for k, v in md.items() if v not in ("", 0)}


def _parse_list(buf, off, size):
    kind = buf[off : off + 4]
    entries = {}
    pos = off + 4
    end = off + size
    while pos + 8 <= end:
        cid = buf[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8 : pos + 8 + csize]
        entries.setdefault(cid.decode("latin-1"), []).append(body)
        pos += 8 + csize + (csize & 1)
    return kind, entries


def load_wav(path, return_buffer=False):
    """Parse a WAV file fully.

    Returns ``(data, rate, md, locs, labels)`` with data normalized to
    [-1, 1] floats, metadata as a nested dict (INFO tags at top level,
    broadcast-wave fields under ``"BEXT"``), and markers as the audioio
    ``locs``/``labels`` arrays.
    """
    # magic probe before slurping the payload: non-WAV branches read the
    # file through their own machinery (a large FLAC would otherwise be
    # read fully here just to be discarded and re-read)
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(16)
    if _wave_container(head) is None:
        empty_locs = np.zeros((0, 2), dtype=np.int64)
        empty_labels = np.zeros((0, 2), dtype=object)
        if return_buffer:
            raise WavError(f"{path}: in-place buffer access requires WAV")
        if head[:4] == b"fLaC":  # native FLAC path (data/flac.py)
            from . import flac

            data, rate = flac.read_flac(path)
            return (data, rate, flac.flac_metadata(path),
                    empty_locs, empty_labels)
        sf = _soundfile()
        if sf is None:
            got = _ff_decode_cached(p)
            if got is None:
                raise _sf_unavailable(path)
            samples, rate = got
            return (samples.astype(np.float64), float(rate), {},
                    empty_locs, empty_labels)
        data, rate = sf.read(str(path), always_2d=True, dtype="float64")
        return data, float(rate), {}, empty_locs, empty_labels
    fmt = None
    data = None
    md = {}
    cues = {}      # id -> position
    lengths = {}   # id -> span (from ltxt)
    names = {}     # id -> label (labl)
    notes = {}     # id -> text (note)
    with p.open("rb") as f:
        for cid, size, off in _walk_wave_chunks(f, path):
            if cid == b"fmt ":
                body = f.read(min(size, _META_CHUNK_CAP))
                fmt = _parse_fmt(body, 0, len(body))
            elif cid == b"data":
                if fmt is None:
                    # same guard as wav_info: a reordered RIFF must
                    # raise WavError, not leak a TypeError from
                    # unpacking None
                    raise WavError(f"{path}: data chunk before fmt")
                tag, channels, rate, bits = fmt
                data = _decode(f.read(size), tag, bits, channels)
            else:
                body = f.read(min(size, _META_CHUNK_CAP))
                _collect_meta(cid, body, 0, len(body), md, cues,
                              lengths, names, notes)
    if fmt is None or data is None:
        raise WavError(f"{path}: missing fmt/data chunk")
    locs, labels = _marker_arrays(cues, lengths, names, notes)
    rate = float(fmt[2])
    if return_buffer:
        return data, rate, md, locs, labels, p.read_bytes()
    return data, rate, md, locs, labels


def _collect_meta(cid, buf, off, size, md, cues, lengths, names, notes):
    """Fold one non-data chunk into the metadata/marker accumulators.

    Tolerant of corrupt bodies: metadata and markers are auxiliary, so
    a truncated ``cue ``/``labl``/``note``/``ltxt``/``bext`` body keeps
    whatever parsed so far and skips the rest instead of failing the
    whole open with a bare ``struct.error`` (every malformed-HEADER
    path in this module raises :class:`WavError`; a malformed side
    chunk should not be fatal at all)."""
    try:
        if cid == b"bext":
            md["BEXT"] = _parse_bext(buf, off, size)
        elif cid == b"LIST":
            kind, entries = _parse_list(buf, off, size)
            if kind == b"INFO":
                for tag4, bodies in entries.items():
                    key = _INFO_TAGS.get(tag4, tag4)
                    md[key] = _cstr(bodies[0])
            elif kind == b"adtl":
                for body in entries.get("labl", []):
                    (cue_id,) = struct.unpack_from("<I", body, 0)
                    names[cue_id] = _cstr(body[4:])
                for body in entries.get("note", []):
                    (cue_id,) = struct.unpack_from("<I", body, 0)
                    notes[cue_id] = _cstr(body[4:])
                for body in entries.get("ltxt", []):
                    cue_id, length = struct.unpack_from("<II", body, 0)
                    lengths[cue_id] = length
        elif cid == b"cue ":
            (ncues,) = struct.unpack_from("<I", buf, off)
            for k in range(ncues):
                base = off + 4 + 24 * k
                cue_id, _, _, _, _, pos = struct.unpack_from("<IIIIII",
                                                             buf, base)
                cues[cue_id] = pos
    except struct.error:
        return


def _marker_arrays(cues, lengths, names, notes):
    ids = sorted(cues)
    locs = np.array(
        [[cues[i], lengths.get(i, 0)] for i in ids], dtype=np.int64
    ).reshape(-1, 2)
    labels = np.array(
        [[names.get(i, ""), notes.get(i, "")] for i in ids], dtype=object
    ).reshape(-1, 2)
    return locs, labels


def scan_wav(path):
    """Header-only scan: ``(rate, md, locs, labels)`` without reading the
    data payload.

    ``metadata()``/``markers()`` used to go through :func:`load_wav`,
    which reads and decodes the whole file — 60+ s for a 368 MB recording
    on this host just to look at header chunks.  This seeks past ``data``
    and parses only the metadata/marker chunks (milliseconds).
    """
    p = Path(path)
    md = {}
    cues, lengths, names, notes = {}, {}, {}, {}
    fmt = None
    with p.open("rb") as f:
        head = f.read(16)
        if _wave_container(head) is None:
            locs, labels = _marker_arrays({}, {}, {}, {})
            if head[:4] == b"fLaC":
                from . import flac

                return (flac.flac_info(p)[0], flac.flac_metadata(p),
                        locs, labels)
            sf = _soundfile()
            if sf is None:
                got = _ff_decode_cached(p)
                if got is None:
                    raise _sf_unavailable(path)
                return float(got[1]), {}, locs, labels
            i = sf.info(str(p))
            return float(i.samplerate), {}, locs, labels
        for cid, size, off in _walk_wave_chunks(f, path):
            if cid == b"data":
                continue  # the walker seeks past the payload
            take = min(size, _META_CHUNK_CAP)
            body = f.read(take)
            if len(body) < take:
                break
            if cid == b"fmt ":
                fmt = _parse_fmt(body, 0, take)
            else:
                _collect_meta(cid, body, 0, take, md, cues, lengths,
                              names, notes)
    if fmt is None:
        raise WavError(f"{path}: missing fmt chunk")
    locs, labels = _marker_arrays(cues, lengths, names, notes)
    return float(fmt[2]), md, locs, labels


def load_audio(path):
    """(data, rate) like audioio's ``load_audio``."""
    data, rate, _, _, _ = load_wav(path)
    return data, rate


def metadata(path):
    _, md, _, _ = scan_wav(path)
    return md


def markers(path):
    _, _, locs, labels = scan_wav(path)
    return locs, labels


def wav_info(path):
    """Cheap header scan: (rate, channels, frames, encoding, data_offset).

    Reads only the chunk headers — used by the out-of-core loader to avoid
    decoding whole files.
    """
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(16)
        if _wave_container(head) is None:
            if head[:4] == b"fLaC":
                from . import flac

                return flac.flac_info(p)
            sf = _soundfile()
            if sf is None:
                got = _ff_decode_cached(p)
                if got is not None:
                    samples, rate = got
                    return (float(rate), int(samples.shape[1]),
                            int(samples.shape[0]), "FFMPEG", None)
                raise _sf_unavailable(path)
            i = sf.info(str(p))
            return (float(i.samplerate), int(i.channels), int(i.frames),
                    f"SF:{i.subtype}", None)
        fmt = None
        for cid, size, off in _walk_wave_chunks(f, path):
            if cid == b"fmt ":
                body = f.read(min(size, _META_CHUNK_CAP))
                fmt = _parse_fmt(body, 0, len(body))
            elif cid == b"data":
                if fmt is None:
                    raise WavError(f"{path}: data before fmt")
                tag, channels, rate, bits = fmt
                # clamp by the real file size: a truncated (or
                # size-corrupted) file must not report frames the read
                # paths can never deliver — this also resolves the
                # streamed-RIFF 0xFFFFFFFF placeholder size
                avail = max(p.stat().st_size - off, 0)
                frames = min(size, avail) // (channels * (bits // 8))
                enc = {(1, 16): "PCM_16", (1, 24): "PCM_24",
                       (1, 32): "PCM_32", (1, 8): "PCM_U8",
                       (3, 32): "FLOAT",
                       (3, 64): "DOUBLE"}.get((tag, bits), f"tag{tag}/{bits}")
                return float(rate), channels, frames, enc, off
    raise WavError(f"{path}: missing fmt/data chunk")


def read_frames(path, start, nframes, info=None):
    """Read a frame range from a WAV file without decoding the rest."""
    if info is None:
        info = wav_info(path)
    rate, channels, frames, enc, data_off = info
    if enc.startswith("FLAC"):  # native FLAC path (data/flac.py)
        from . import flac

        return flac.read_frames(path, start, nframes)
    if enc == "FFMPEG":  # system-FFmpeg fallback (non-WAV container)
        got = _ff_decode_cached(Path(path))
        if got is None:
            raise _sf_unavailable(path)
        samples, _rate = got
        start = max(0, min(start, frames))
        nframes = max(0, min(nframes, frames - start))
        return samples[start : start + nframes].astype(np.float64)
    if data_off is None:  # soundfile-backed (non-WAV container)
        sf = _soundfile()
        start = max(0, min(start, frames))
        nframes = max(0, min(nframes, frames - start))
        with sf.SoundFile(str(path)) as f:
            f.seek(start)
            return f.read(nframes, dtype="float64", always_2d=True)
    tag, bits = _ENCODINGS.get(enc, (None, None))
    if tag is None:
        raise WavError(f"{path}: unsupported encoding {enc}")
    bpf = channels * (bits // 8)
    start = max(0, min(start, frames))
    nframes = max(0, min(nframes, frames - start))
    with Path(path).open("rb") as f:
        f.seek(data_off + start * bpf)
        raw = f.read(nframes * bpf)
    return _decode(raw, tag, bits, channels)


def read_frames_raw16(path, start, nframes, info, out):
    """Read PCM-16 frames as raw little-endian int16 — no float decode.

    The on-disk samples ARE the quantized values the device dequantizes
    (sample = k / 2**15, the convention shared by :func:`read_frames` and
    ``Data._put_raw``), so for int16 device uploads the f32 decode +
    re-quantize round trip is pure waste; this reads the bytes straight
    into ``out`` (a C-contiguous ``(>=nframes, channels)`` int16 array)
    with one ``readinto`` from the page cache.

    Returns the number of frames read (short files return fewer; the
    caller zero-fills).  Raises :class:`WavError` for non-PCM-16 or
    soundfile-backed sources — callers probe support once via
    ``info[3] == "PCM_16" and info[4] is not None``.
    """
    rate, channels, frames, enc, data_off = info
    if enc == "FLAC_16":  # 16-bit FLAC: decode codes straight to int16
        from . import flac

        if (out.dtype != np.int16 or out.ndim != 2
                or out.shape[1] != channels or out.shape[0] < nframes
                or not out.flags.c_contiguous):
            raise ValueError("out must be C-contiguous int16 "
                             f"(>= {nframes}, {channels})")
        return flac.read_frames_raw16(path, start, nframes, out)
    if enc != "PCM_16" or data_off is None:
        raise WavError(f"{path}: raw16 read needs PCM_16 WAV, got {enc}")
    if (out.dtype != np.int16 or out.ndim != 2
            or out.shape[1] != channels or out.shape[0] < nframes
            or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous int16 "
                         f"(>= {nframes}, {channels})")
    bpf = channels * 2
    start = max(0, min(start, frames))
    nframes = max(0, min(nframes, frames - start))
    with Path(path).open("rb") as f:
        f.seek(data_off + start * bpf)
        view = memoryview(out).cast("B")
        nbytes = f.readinto(view[: nframes * bpf])
    if sys.byteorder != "little":  # pragma: no cover - LE hosts only here
        out[: nbytes // bpf].byteswap(inplace=True)
    return nbytes // bpf


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _encode(data, encoding):
    tag, bits = _ENCODINGS[encoding]
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if np.issubdtype(data.dtype, np.unsignedinteger):
        raise WavError("unsigned integer samples are ambiguous; pass "
                       "signed PCM codes or float in [-1, 1]")
    if np.issubdtype(data.dtype, np.integer):
        # integer input is PCM codes at the dtype's width (the raw16
        # convention k / 2^15 for int16, k / 2^31 for int32) — NOT
        # floats to clip.  An int16 array written as PCM_16 round-trips
        # bit-exactly.
        width = data.dtype.itemsize * 8
        data = data.astype(np.float64) / float(2 ** (width - 1))
    if tag == 3:
        return data.astype("<f4" if bits == 32 else "<f8").tobytes(), tag, bits
    clipped = np.clip(data, -1.0, 1.0 - 2.0 ** (1 - bits))
    scaled = np.round(clipped * 2 ** (bits - 1)).astype(np.int64)
    if bits == 16:
        return scaled.astype("<i2").tobytes(), tag, bits
    if bits == 32:
        return scaled.astype("<i4").tobytes(), tag, bits
    if bits == 24:
        ints = scaled.astype(np.int64) & 0xFFFFFF
        b = np.empty(ints.shape + (3,), np.uint8)
        b[..., 0] = ints & 0xFF
        b[..., 1] = (ints >> 8) & 0xFF
        b[..., 2] = (ints >> 16) & 0xFF
        return b.tobytes(), tag, bits
    if bits == 8:  # unsigned, 128 offset (the _decode inverse)
        return (np.clip(scaled + 128, 0, 255).astype(np.uint8).tobytes(),
                tag, bits)
    raise WavError(f"unsupported encoding {encoding}")


def _chunk_exact(cid, body):
    pad = b"\x00" if len(body) & 1 else b""
    return cid + struct.pack("<I", len(body)) + body + pad


def _build_bext(bext):
    body = b""
    for name, n in _BEXT_FIELDS:
        body += str(bext.get(name, ""))[:n].encode("latin-1", "replace").ljust(n, b"\x00")
    tr = int(bext.get("TimeReference", 0))
    body += struct.pack("<II", tr & 0xFFFFFFFF, tr >> 32)
    body += struct.pack("<H", int(bext.get("Version", 1)))
    body += b"\x00" * 64   # UMID
    body += b"\x00" * 10   # loudness
    body += b"\x00" * 180  # reserved
    hist = str(bext.get("CodingHistory", ""))
    if hist:
        body += hist.encode("latin-1", "replace")
        if not body.endswith(b"\r\n"):
            body += b"\r\n"
    return body


def write_audio(path, data, rate, metadata=None, locs=None, labels=None,
                encoding="PCM_16", format="WAV"):
    """Write a WAV file with optional metadata and markers.

    API shape follows audioio's ``write_audio``; the reference's region
    export goes through this (`src/audian/databrowser.py:1913-1918`).

    A ``.flac`` suffix routes to the FLAC encoder even under the
    default ``format="WAV"`` (the suffix is the explicit user signal;
    audioio resolves format from the suffix the same way) — pass
    ``format="WAV"`` with a ``.wav`` path to force a WAV container.
    In the FLAC branch ``encoding`` selects the stored bit depth
    (``PCM_16``/``PCM_24``/``PCM_32``; ``FLAC`` = match the input
    dtype); float encodings raise, FLAC is integer-only.

    Payloads whose RIFF form would exceed the 32-bit chunk-size cap are
    written as RF64 (EBU tech 3306: ``RF64`` magic + a ``ds64`` chunk
    carrying the 64-bit sizes) automatically instead of dying on the
    ``<I`` pack; ``format="RF64"`` forces the RF64 container for any
    size.  For incremental multi-GB writes use :class:`WavWriter`.
    """
    if (format or "").upper() == "FLAC" or encoding.upper() == "FLAC" \
            or ((format or "WAV").upper() == "WAV"
                and str(path).lower().endswith(".flac")):
        from . import flac

        if locs is not None and len(locs):
            raise ValueError(
                "FLAC has no cue-marker chunk; export markers to "
                "CSV/XLSX or write a WAV")
        flac_bits = {"FLAC": None, "PCM_16": 16, "PCM_24": 24,
                     "PCM_32": 32}
        enc = (encoding or "FLAC").upper()
        if enc not in flac_bits:
            raise ValueError(
                f"FLAC cannot store encoding {encoding}: FLAC is "
                "integer-only (PCM_16/PCM_24/PCM_32)")
        return flac.write_flac(path, np.asarray(data), rate,
                               metadata=metadata, bits=flac_bits[enc])
    force_rf64 = bool(format) and format.upper() == "RF64"
    suffix_fmt = None
    if (format or "WAV").upper() == "WAV":
        # like the .flac rule above, a target suffix is the explicit
        # user signal (the save dialog passes only a path)
        sfx = str(path).lower().rsplit(".", 1)
        suffix_fmt = {"ogg": "OGG", "oga": "OGG", "aiff": "AIFF",
                      "aif": "AIFF", "mp3": "MP3", "opus": "OPUS"}.get(
                          sfx[-1] if len(sfx) > 1 else "")
    if (format and format.upper() not in ("WAV", "RF64")) or suffix_fmt:
        # FFmpeg-backed export (OGG/AIFF/MP3/...) when the system
        # libraries are present — the same breadth the reference gets
        # from libsndfile's datawriter formats
        from .. import native

        fmt = suffix_fmt or format.upper()
        if fmt in native.FF_EXPORT_FORMATS:
            if locs is not None and len(locs):
                raise ValueError(
                    f"{fmt} has no cue-marker chunk; export markers to "
                    "CSV/XLSX or write a WAV")
            arr = np.asarray(data)
            if np.issubdtype(arr.dtype, np.unsignedinteger):
                raise WavError("unsigned integer samples are ambiguous;"
                               " pass signed PCM codes or float")
            if np.issubdtype(arr.dtype, np.integer):
                # integer input is PCM codes (the _encode convention)
                width = arr.dtype.itemsize * 8
                arr = arr.astype(np.float64) / float(2 ** (width - 1))
            if native.ff_audio_encode(path, arr.astype(np.float32),
                                      rate, format=fmt,
                                      metadata=metadata):
                return Path(path)
            raise WavError(
                f"{path}: {fmt} export needs the system FFmpeg "
                "libraries (libavformat/libavcodec), which are not "
                "available; write a WAV or FLAC instead")
        raise ValueError(f"unsupported format: {format}")
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    raw, tag, bits = _encode(data, encoding)
    channels = data.shape[1]
    bpf = channels * (bits // 8)
    # ByteRate is informational; clamp it for the huge synthetic rates the
    # fulltrace cache uses (rate scaled by 1e6, compresseddata.py:198-202)
    byte_rate = min(int(round(rate)) * bpf, 0xFFFFFFFF)
    chunks = [
        _chunk_exact(
            b"fmt ",
            struct.pack("<HHIIHH", tag, channels, int(round(rate)),
                        byte_rate, bpf, bits),
        )
    ]
    md = dict(metadata or {})
    bext = md.pop("BEXT", None)
    if bext:
        chunks.append(_chunk_exact(b"bext", _build_bext(bext)))
    info_entries = b""
    for key, val in md.items():
        if isinstance(val, dict):
            continue  # non-INFO sections are not representable
        tag4 = _INFO_TAGS_INV.get(key, key if len(key) == 4 else None)
        if tag4 is None:
            continue
        body = str(val).encode("latin-1", "replace") + b"\x00"
        info_entries += _chunk_exact(tag4.encode("latin-1"), body)
    if info_entries:
        chunks.append(_chunk_exact(b"LIST", b"INFO" + info_entries))
    if locs is not None and len(locs):
        locs = np.asarray(locs)
        if locs.ndim == 1:
            locs = np.stack([locs, np.zeros_like(locs)], axis=1)
        cue = struct.pack("<I", len(locs))
        adtl = b""
        for k, (pos, span) in enumerate(locs):
            cue += struct.pack("<IIIIII", k + 1, int(pos), 0x61746164, 0, 0,
                               int(pos))
            label, text = "", ""
            if labels is not None and k < len(labels):
                pair = np.atleast_1d(labels[k])
                label = str(pair[0]) if len(pair) > 0 and pair[0] else ""
                text = str(pair[1]) if len(pair) > 1 and pair[1] else ""
            if label:
                adtl += _chunk_exact(
                    b"labl", struct.pack("<I", k + 1)
                    + label.encode("latin-1", "replace") + b"\x00")
            if text:
                adtl += _chunk_exact(
                    b"note", struct.pack("<I", k + 1)
                    + text.encode("latin-1", "replace") + b"\x00")
            if span:
                adtl += _chunk_exact(
                    b"ltxt",
                    struct.pack("<II", k + 1, int(span)) + b"\x00" * 12)
        chunks.append(_chunk_exact(b"cue ", cue))
        if adtl:
            chunks.append(_chunk_exact(b"LIST", b"adtl" + adtl))
    meta = b"".join(chunks)
    data_size = len(raw)
    pad = b"\x00" if data_size & 1 else b""
    riff_size = 4 + len(meta) + 8 + data_size + len(pad)
    with Path(path).open("wb") as f:
        if riff_size <= _RIFF_MAX and not force_rf64:
            f.write(b"RIFF" + struct.pack("<I", riff_size) + b"WAVE")
            f.write(meta)
            f.write(b"data" + struct.pack("<I", data_size))
        else:
            # RF64: 32-bit size fields hold the 0xFFFFFFFF placeholder,
            # the true 64-bit riff/data sizes live in the leading ds64
            ds64 = struct.pack("<QQQI", riff_size + 36, data_size,
                               data_size // max(bpf, 1), 0)
            f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE")
            f.write(b"ds64" + struct.pack("<I", len(ds64)) + ds64)
            f.write(meta)
            f.write(b"data" + struct.pack("<I", 0xFFFFFFFF))
        f.write(raw)
        f.write(pad)


class WavWriter:
    """Incremental WAV writer with automatic RF64 promotion past 4 GiB.

    Appends frames as they arrive (a field recorder's write path — the
    reference gets this from libsndfile) without holding the recording
    in memory.  The header reserves a 28-byte ``JUNK`` chunk after the
    RIFF id; :meth:`close` patches the true sizes in place, and when the
    file outgrew the 32-bit RIFF caps it rewrites the magic to ``RF64``
    and the ``JUNK`` into the ``ds64`` chunk carrying the 64-bit sizes
    (EBU tech 3306's recommended promotion scheme, so the bytes before
    the payload never move).  Use as a context manager::

        with WavWriter(path, rate, channels) as w:
            for block in blocks:
                w.write(block)

    ``write`` accepts float frames in [-1, 1] or integer PCM codes (the
    :func:`write_audio` convention); int16 input under ``PCM_16`` is
    appended without a float round trip.  :meth:`skip_frames` extends
    the file with silence sparsely (zero PCM codes without writing the
    bytes) — multi-GB synthetic corpora cost only their header plus the
    probed regions on disk.
    """

    def __init__(self, path, rate, channels, encoding="PCM_16"):
        if encoding not in _ENCODINGS:
            raise WavError(f"unsupported encoding {encoding}")
        self.path = Path(path)
        self.rate = float(rate)
        self.channels = int(channels)
        self.encoding = encoding
        tag, bits = _ENCODINGS[encoding]
        self._tag, self._bits = tag, bits
        self._bpf = self.channels * (bits // 8)
        self._frames = 0
        byte_rate = min(int(round(self.rate)) * self._bpf, 0xFFFFFFFF)
        f = self.path.open("wb")
        try:
            # 0xFFFFFFFF placeholders (the streaming-writer convention),
            # NOT zeros: if the process dies before close() patches the
            # real sizes, readers clamp the data span by the file size
            # (wav_info's `avail` clamp) and every written frame is
            # still recoverable instead of reading back as 0 frames
            f.write(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE")
            f.write(b"JUNK" + struct.pack("<I", 28) + b"\x00" * 28)
            f.write(_chunk_exact(
                b"fmt ",
                struct.pack("<HHIIHH", tag, self.channels,
                            int(round(self.rate)), byte_rate,
                            self._bpf, bits)))
            self._data_hdr = f.tell()
            f.write(b"data" + struct.pack("<I", 0xFFFFFFFF))
            self._data_off = f.tell()
        except BaseException:
            f.close()
            raise
        self._f = f

    @property
    def frames(self):
        return self._frames

    def write(self, data):
        """Append frames (shape ``(n,)`` or ``(n, channels)``)."""
        if self._f is None:
            raise WavError(f"{self.path}: writer is closed")
        data = np.asarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[1] != self.channels:
            raise WavError(
                f"expected {self.channels} channels, got {data.shape[1]}")
        if data.dtype == np.int16 and self.encoding == "PCM_16":
            raw = np.ascontiguousarray(data, "<i2").tobytes()
        else:
            raw, _tag, _bits = _encode(data, self.encoding)
        self._f.write(raw)
        self._frames += len(data)
        return self

    def skip_frames(self, n):
        """Extend with ``n`` silent frames without writing their bytes
        (a sparse hole on the filesystem; zero PCM codes decode as
        silence in every supported encoding)."""
        if self._f is None:
            raise WavError(f"{self.path}: writer is closed")
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot skip {n} frames")
        if n:
            self._f.seek(n * self._bpf - 1, 1)
            self._f.write(b"\x00")
        self._frames += n
        return self

    def close(self):
        """Patch the deferred sizes (promoting to RF64 if needed)."""
        f, self._f = self._f, None
        if f is None:
            return
        try:
            true_size = self._frames * self._bpf
            padded = true_size + (true_size & 1)
            if true_size & 1:  # odd bpf (e.g. PCM_24 mono): pad byte
                f.seek(self._data_off + true_size)
                f.write(b"\x00")
            riff_size = self._data_off + padded - 8
            if riff_size <= _RIFF_MAX:
                f.seek(4)
                f.write(struct.pack("<I", riff_size))
                f.seek(self._data_hdr + 4)
                f.write(struct.pack("<I", true_size))
            else:
                f.seek(0)
                f.write(b"RF64" + struct.pack("<I", 0xFFFFFFFF))
                f.seek(12)
                f.write(b"ds64" + struct.pack("<I", 28))
                f.write(struct.pack("<QQQI", riff_size, true_size,
                                    self._frames, 0))
                f.seek(self._data_hdr + 4)
                f.write(struct.pack("<I", 0xFFFFFFFF))
        finally:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# metadata helpers (audioio API surface used by the reference)
# ---------------------------------------------------------------------------


def get_datetime(md):
    """Recording start datetime from metadata (BEXT OriginationDate/Time or
    INFO ICRD/Date), or None."""
    bext = md.get("BEXT", {})
    date = bext.get("OriginationDate")
    time = bext.get("OriginationTime", "00:00:00")
    if date:
        try:
            return dt.datetime.fromisoformat(f"{date}T{time}")
        except ValueError:
            pass
    date = md.get("Date") or md.get("ICRD")
    if date:
        try:
            return dt.datetime.fromisoformat(str(date))
        except ValueError:
            pass
    return None


def update_starttime(md, deltat, rate):
    """Shift the recording start time by ``deltat`` seconds (used when a
    region is cut out, `src/audian/databrowser.py:1892`)."""
    start = get_datetime(md)
    if start is not None:
        new = start + dt.timedelta(seconds=float(deltat))
        if "BEXT" in md and "OriginationDate" in md["BEXT"]:
            md["BEXT"]["OriginationDate"] = new.date().isoformat()
            md["BEXT"]["OriginationTime"] = new.time().strftime("%H:%M:%S")
        if "Date" in md:
            md["Date"] = new.isoformat()
    bext = md.get("BEXT")
    if bext and "TimeReference" in bext:
        bext["TimeReference"] = int(bext["TimeReference"]) + int(
            round(float(deltat) * rate))
    return md


def bext_history_str(encoding, rate, channels, text=None):
    """One BWF CodingHistory line, ``A=PCM,F=...,W=...,M=...``."""
    enc = str(encoding or "PCM_16").upper()
    bits = {"FLOAT": 32, "DOUBLE": 64}.get(enc)
    if bits is None:
        # PCM_16/24/32, PCM_U8, FLAC_16/24/... — the trailing digits
        # are the word length
        tail = "".join(c for c in enc.rsplit("_", 1)[-1] if c.isdigit())
        bits = int(tail) if tail else 16
    mode = {1: "mono", 2: "stereo"}.get(int(channels), f"{channels}ch")
    s = f"A=PCM,F={int(round(rate))},W={bits},M={mode}"
    if text:
        s += f",T={text}"
    return s


def add_history(md, history, key="CodingHistory", pre_history=None):
    """Append a history line to the metadata under ``key`` (dotted path
    allowed), seeding with ``pre_history`` if the field was empty."""
    d = md
    parts = key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    field = parts[-1]
    old = d.get(field, "")
    if not old and pre_history:
        old = pre_history
    d[field] = (old + "\r\n" + history) if old else history
    return md


def unwrap(data, thresh=1.5, clips=False, ampl_max=1.0, start_shift=0.0,
           return_shift=False):
    """Unwrap data that wrapped around the ADC range: where consecutive
    samples jump by more than ``thresh*ampl_max``, shift by the full range.
    Then either clip to the range or scale down by two (the reference's
    ``-U`` vs ``-u`` CLI flags, `src/audian/audian.py:1485-1490`).

    ``start_shift`` seeds the cumulative (input-space) shift so a
    sequential block scan can continue a wrap that is still active at a
    block boundary; ``return_shift=True`` additionally returns the final
    cumulative shift to carry into the next block.
    """
    data = np.array(data, dtype=np.float64, copy=True)
    rng = 2.0 * ampl_max
    d = np.diff(data, axis=0)
    steps = np.zeros_like(data)
    steps[1:] = -rng * np.where(d > thresh * ampl_max, 1.0,
                                np.where(d < -thresh * ampl_max, -1.0, 0.0))
    shift = np.cumsum(steps, axis=0) + start_shift
    data += shift
    final = shift[-1] if len(data) else start_shift
    if clips:
        np.clip(data, -ampl_max, ampl_max, out=data)
    else:
        data *= 0.5
    if return_shift:
        return data, final
    return data
