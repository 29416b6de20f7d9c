"""Native FLAC support: decoder (+ a subset encoder) with no external
dependencies.

The reference hard-depends on SoundFile/libsndfile so FLAC recordings
always open (`/root/reference/pyproject.toml:17`); here WAV is decoded
in-repo and everything else used to require the optional ``soundfile``
extra.  This module closes that gap for FLAC — the dominant compressed
format for bioacoustics archives — so ``audian recording.flac`` works on
a bare install:

- **decoder**: the full FLAC subset streams actually use — fixed and
  variable blocking, all block-size/sample-rate/sample-size codes,
  independent + left/side + right/side + mid/side channel assignments,
  CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits,
  RICE and RICE2 residuals with partitions and escape codes;
- **random access**: a per-file frame index — an exhaustive CRC-8
  validated sync-code scan for small files, and for large files a
  *lazy* index (libFLAC's open behavior): open() reads metadata only,
  seeks bisect the byte range with decode-verified probes seeded by
  SEEKTABLE points, and sequential reads chain frame-to-frame — so a
  multi-GB archive opens in milliseconds and the out-of-core loader
  decodes only the frames covering a requested window;
- **encoder** (:func:`write_flac`): 8/12/16/20/24/32-bit, fixed
  4096-sample blocks, per-subframe best-of CONSTANT / FIXED(0-4) /
  LPC(Levinson-Durbin, 15-bit quantized coefficients) / VERBATIM with
  partitioned Rice residuals and wasted-bits packing, per-frame stereo
  decorrelation (left/right/mid-side), a SEEKTABLE (a point every
  ~10 s), and a true STREAMINFO MD5 — validated bit-exact against
  FFmpeg's libavcodec decoder (``native/ffflac.cc``) and used by
  ``write_audio(..., encoding="FLAC")`` and the round-trip tests.

The hot decode loop and the whole encoder also exist in C++
(``audian_tpu.native``: ``flacdec.cc``, ``flacenc.cc`` — the
production paths, ~2 orders of magnitude faster); this Python
implementation is the correctness reference and the fallback when the
native library cannot build.  Both directions are validated bit-exact
against external codecs (FFmpeg's libavcodec via ``native/ffflac.cc``,
libFLAC's ``flac`` binary in CI — `tests/test_flac_interop.py`,
`tests/test_libflac_cli.py`, golden assets in `tests/data/golden`).
"""

from __future__ import annotations

import hashlib
import os
import struct
from pathlib import Path

import numpy as np

__all__ = ["is_flac", "flac_info", "read_flac", "write_flac",
           "read_frames", "flac_metadata", "FlacError"]


from .wavio import WavError


class FlacError(WavError):
    """FLAC parse/decode failure — a :class:`wavio.WavError`, so the
    open/read error contracts treat corrupt FLAC like corrupt WAV."""


# -- CRCs (FLAC polynomials) ------------------------------------------------------


def _crc_table(poly, bits):
    table = np.zeros(256, np.uint32)
    top = 1 << (bits - 1)
    mask = (1 << bits) - 1
    for i in range(256):
        c = i << (bits - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def _crc8(data):
    c = 0
    for b in data:
        c = int(_CRC8[(c ^ b) & 0xFF])
    return c


def _crc16(data):
    c = 0
    for b in data:
        c = int(_CRC16[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)
    return c


# -- bit I/O ---------------------------------------------------------------------


class _BitReader:
    """MSB-first bit reader over a bytes buffer."""

    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos      # byte position
        self.bit = 0        # bits consumed of buf[pos]

    def read(self, nbits):
        v = 0
        while nbits > 0:
            if self.pos >= len(self.buf):
                raise FlacError("truncated FLAC stream")
            avail = 8 - self.bit
            take = min(nbits, avail)
            byte = self.buf[self.pos]
            v = (v << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            self.bit += take
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
            nbits -= take
        return v

    def read_signed(self, nbits):
        v = self.read(nbits)
        if v >= (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    def read_unary(self):
        n = 0
        while True:
            if self.pos >= len(self.buf):
                raise FlacError("truncated FLAC stream")
            byte = self.buf[self.pos]
            avail = 8 - self.bit
            chunk = byte & ((1 << avail) - 1)
            if chunk == 0:
                n += avail
                self.bit = 0
                self.pos += 1
                continue
            lead = avail - chunk.bit_length()
            n += lead
            self.bit += lead + 1
            if self.bit >= 8:
                self.bit -= 8
                self.pos += 1
            return n

    def align(self):
        if self.bit:
            self.bit = 0
            self.pos += 1


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def write(self, value, nbits):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nacc += nbits
        while self.nacc >= 8:
            self.nacc -= 8
            self.out.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def write_unary(self, n):
        while n >= 32:
            self.write(0, 32)
            n -= 32
        self.write(1, n + 1)

    def align(self):
        if self.nacc:
            self.write(0, 8 - self.nacc)

    def bytes(self):
        assert self.nacc == 0
        return bytes(self.out)


# -- stream-level parsing ---------------------------------------------------------


def is_flac(path):
    try:
        with Path(path).open("rb") as f:
            return f.read(4) == b"fLaC"
    except OSError:
        return False


def _read_streaminfo(f):
    """Parse the metadata blocks; returns (info dict, first audio byte)."""
    if f.read(4) != b"fLaC":
        raise FlacError("not a FLAC stream")
    info = None
    comments = {}
    seekpoints = []
    while True:
        hdr = f.read(4)
        if len(hdr) < 4:
            raise FlacError("truncated FLAC metadata")
        last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = f.read(size)
        if len(body) < size:
            raise FlacError("truncated FLAC metadata block")
        if btype == 4:  # VORBIS_COMMENT ("KEY=value" pairs)
            try:
                (vlen,) = struct.unpack_from("<I", body, 0)
                pos = 4 + vlen
                (ncom,) = struct.unpack_from("<I", body, pos)
                pos += 4
                for _ in range(ncom):
                    (clen,) = struct.unpack_from("<I", body, pos)
                    pos += 4
                    entry = body[pos : pos + clen].decode(
                        "utf-8", "replace")
                    pos += clen
                    key, _, value = entry.partition("=")
                    if key:
                        comments[key] = value
            except (struct.error, IndexError):
                pass  # malformed comment block: audio still decodes
        if btype == 3:  # SEEKTABLE: (sample, byte offset, span) records
            for rec in range(size // 18):
                sample, off, _span = struct.unpack_from(
                    ">QQH", body, rec * 18)
                if sample != 0xFFFFFFFFFFFFFFFF:  # placeholder point
                    seekpoints.append((sample, off))
        if btype == 0:
            br = _BitReader(body)
            min_bs = br.read(16)
            max_bs = br.read(16)
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            rate = br.read(20)
            channels = br.read(3) + 1
            bits = br.read(5) + 1
            total = br.read(36)
            info = dict(min_blocksize=min_bs, max_blocksize=max_bs,
                        rate=rate, channels=channels, bits=bits,
                        total=total)
        if last:
            break
    if info is None:
        raise FlacError("FLAC stream without STREAMINFO")
    info["comments"] = comments
    info["seekpoints"] = seekpoints
    return info, f.tell()


def flac_info(path):
    """``(rate, channels, frames, encoding, None)`` — the
    :func:`audian_tpu.data.wavio.wav_info` tuple shape (no byte offset:
    FLAC frames are found through the frame index)."""
    with Path(path).open("rb") as f:
        info, _ = _read_streaminfo(f)
    if info["total"] == 0:
        # "unknown length" streams: the frame index knows the truth
        try:
            info = _open(path).sinfo
        except FlacError:
            pass  # no frames at all: report the declared zero
    return (float(info["rate"]), int(info["channels"]),
            int(info["total"]), f"FLAC_{info['bits']}", None)


# -- frame header parsing ---------------------------------------------------------

_BLOCKSIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_CODES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}
_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _parse_frame_header(buf, pos, sinfo):
    """Parse and CRC-validate a frame header at byte ``pos``.

    Returns ``(reader, blocksize, channel_assignment, bits, position)``
    where ``position`` is the frame's first-sample index, or ``None``
    when the bytes are not a valid frame header (sync-scan rejection).
    """
    br = _BitReader(buf, pos)
    try:
        if br.read(14) != 0x3FFE or br.read(1) != 0:
            return None
        variable = br.read(1)
        bs_code = br.read(4)
        sr_code = br.read(4)
        ca = br.read(4)
        ss_code = br.read(3)
        if br.read(1) != 0 or bs_code == 0 or ca > 10 or ss_code == 3:
            return None
        # UTF-8-style coded frame/sample number (up to 36/31 bits)
        first = br.read(8)
        if first < 0x80:
            num = first
        else:
            nbytes = 0
            probe = first
            while probe & 0x40:
                nbytes += 1
                probe <<= 1
            if not (probe & 0x80) or nbytes < 1 or nbytes > 6:
                return None
            num = first & (0x3F >> nbytes)
            for _ in range(nbytes):
                cont = br.read(8)
                if (cont & 0xC0) != 0x80:
                    return None
                num = (num << 6) | (cont & 0x3F)
        if bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_CODES[bs_code]
        if sr_code == 0:
            rate = sinfo["rate"]
        elif sr_code == 12:
            rate = br.read(8) * 1000
        elif sr_code == 13:
            rate = br.read(16)
        elif sr_code == 14:
            rate = br.read(16) * 10
        elif sr_code == 15:
            return None
        else:
            rate = _RATE_CODES[sr_code]
        bits = sinfo["bits"] if ss_code == 0 else _SIZE_CODES[ss_code]
        if br.bit != 0 or br.pos >= len(buf):
            # header always ends byte-aligned before CRC-8; a candidate
            # ending exactly at EOF is not a frame
            return None
        crc = buf[br.pos]
        if _crc8(buf[pos : br.pos]) != crc:
            return None
        br.pos += 1
        nch = (ca + 1) if ca < 8 else 2
        if nch != sinfo["channels"] or rate != sinfo["rate"] \
                or bits != sinfo["bits"]:
            return None
        if not variable and \
                sinfo["min_blocksize"] != sinfo["max_blocksize"]:
            # a fixed-strategy frame positions itself as
            # num * max_blocksize, which is only meaningful when
            # STREAMINFO says the stream IS fixed-blocksize
            # (min == max); in a nonconforming stream the lazy index
            # would silently mis-seek — fail loudly instead (the native
            # decoder applies the same rejection)
            return None
        position = num if variable else num * sinfo["max_blocksize"]
        return br, blocksize, ca, bits, position
    except FlacError:
        return None


# -- frame decoding ---------------------------------------------------------------


def _decode_residual(br, blocksize, order):
    method = br.read(2)
    if method > 1:
        raise FlacError("reserved residual coding method")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    po = br.read(4)
    npart = 1 << po
    if blocksize % npart or (blocksize >> po) < order:
        raise FlacError("invalid partition order")
    out = np.empty(blocksize - order, np.int64)
    idx = 0
    for p in range(npart):
        n = (blocksize >> po) - (order if p == 0 else 0)
        param = br.read(pbits)
        if param == escape:
            raw = br.read(5)
            for i in range(n):
                out[idx + i] = br.read_signed(raw) if raw else 0
        else:
            for i in range(n):
                q = br.read_unary()
                u = (q << param) | br.read(param)
                out[idx + i] = (u >> 1) ^ -(u & 1)
        idx += n
    return out


_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_subframe(br, blocksize, bps):
    if br.read(1) != 0:
        raise FlacError("invalid subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps = bps - wasted
    if bps <= 0 or bps > 33:
        raise FlacError("invalid wasted-bits count")
    if stype == 0:  # CONSTANT
        x = np.full(blocksize, br.read_signed(bps), np.int64)
    elif stype == 1:  # VERBATIM
        x = np.fromiter((br.read_signed(bps) for _ in range(blocksize)),
                        np.int64, blocksize)
    elif 8 <= stype <= 12:  # FIXED, order = stype - 8
        order = stype - 8
        if order > blocksize:
            raise FlacError("predictor order exceeds block size")
        x = np.empty(blocksize, np.int64)
        for i in range(order):
            x[i] = br.read_signed(bps)
        res = _decode_residual(br, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for i in range(order, blocksize):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * x[i - 1 - j]
            x[i] = acc
    elif stype >= 32:  # LPC, order = (stype & 31) + 1
        order = (stype & 31) + 1
        if order > blocksize:
            raise FlacError("predictor order exceeds block size")
        x = np.empty(blocksize, np.int64)
        for i in range(order):
            x[i] = br.read_signed(bps)
        precision = br.read(4)
        if precision == 15:
            raise FlacError("invalid LPC precision code")
        precision += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, blocksize, order)
        for i in range(order, blocksize):
            acc = 0
            for j in range(order):
                acc += coefs[j] * int(x[i - 1 - j])
            x[i] = (acc >> shift) + res[i - order]
    else:
        raise FlacError(f"reserved subframe type {stype}")
    if wasted:
        x = x << wasted
    return x


def _decode_frame(buf, pos, sinfo):
    parsed = _parse_frame_header(buf, pos, sinfo)
    if parsed is None:
        raise FlacError(f"no valid frame header at byte {pos}")
    br, blocksize, ca, bits, position = parsed
    nch = sinfo["channels"]
    chans = []
    for c in range(nch):
        bps = bits
        if (ca == 8 and c == 1) or (ca == 9 and c == 0) \
                or (ca == 10 and c == 1):
            bps += 1  # the side channel carries one extra bit
        chans.append(_decode_subframe(br, blocksize, bps))
    if ca == 8:      # left/side: right = left - side
        left, side = chans
        chans = [left, left - side]
    elif ca == 9:    # side/right: left = side + right
        side, right = chans
        chans = [side + right, right]
    elif ca == 10:   # mid/side
        mid, side = chans
        m = (mid << 1) | (side & 1)
        chans = [(m + side) >> 1, (m - side) >> 1]
    br.align()
    # frame CRC-16 over header+payload: bit corruption inside a frame
    # must fail loudly, not ship silently wrong samples (the reference's
    # libsndfile path reports such frames as read errors)
    if br.pos + 2 > len(buf):
        raise FlacError("truncated FLAC frame (missing CRC-16)")
    stored = (buf[br.pos] << 8) | buf[br.pos + 1]
    if _crc16(buf[pos : br.pos]) != stored:
        raise FlacError(f"FLAC frame CRC-16 mismatch at byte {pos}")
    br.pos += 2
    return np.stack(chans, axis=1), position, br.pos


# -- frame index ------------------------------------------------------------------


def _longest_increasing(values):
    """Indices of the longest strictly-increasing subsequence.

    Ties keep the FIRST occurrence: a later candidate with an equal
    value cannot extend a strict chain any further, and replacing the
    tail would let a sync-scan impostor that duplicates a real frame's
    position displace the real frame from the index."""
    import bisect

    tails = []      # smallest tail value per chain length
    tail_idx = []   # index of that tail
    prev = [-1] * len(values)
    for i, v in enumerate(values):
        j = bisect.bisect_left(tails, v)
        if j < len(tails) and tails[j] == v:
            continue  # duplicate value: first occurrence stays
        if j == len(tails):
            tails.append(v)
            tail_idx.append(i)
        else:
            tails[j] = v
            tail_idx[j] = i
        prev[i] = tail_idx[j - 1] if j else -1
    out = []
    i = tail_idx[-1] if tail_idx else -1
    while i >= 0:
        out.append(i)
        i = prev[i]
    return out[::-1]


# Files at or below this size get the exhaustive sync-scan index (one
# numpy pass; also the oracle the lazy index is tested against); larger
# files use the lazy bisection index so open() touches only metadata.
_EAGER_INDEX_MAX = 4 << 20
# Stop bisecting once the target is within this many blocks of the best
# anchor (decoding a few frames beats more probe scans) ...
_SEEK_SLACK_BLOCKS = 3
# ... or once the candidate byte range is this small (a linear decode
# through it is at most a handful of frames).
_SEEK_MIN_BYTES = 1 << 16
# Probe scans and resyncs examine the stream in windows of this size.
_SCAN_CHUNK = 1 << 18


class _FlacFile:
    """Parsed stream + CRC-validated frame index for random access.

    Two index modes (``index=None`` picks by file size):

    - **eager**: one vectorized sync-code scan over the whole stream;
      every candidate 0xFF F8-FB byte pair is validated by full header
      parse + CRC-8 + streaminfo consistency, and impostors are dropped
      by a longest-increasing-positions filter.  Exhaustive, O(file) —
      right for small files and the oracle for the lazy mode.
    - **lazy**: open() reads metadata only (libFLAC's behavior — the
      reference gets this via libsndfile).  Random access bisects the
      byte range, validating each probe by decoding a whole frame
      (header CRC-8 + frame CRC-16), seeded by any SEEKTABLE points;
      sequential reads chain frame-to-frame through each frame's end
      offset.  A multi-GB archive on this ~6 MB/s disk opens in
      milliseconds instead of a full-file read.
    """

    def __init__(self, path, index=None):
        import mmap

        self.path = Path(path)
        # mmap the stream so the index and per-frame decodes page in
        # lazily: a multi-GB archive costs address space, not RSS
        # (mmap slicing returns bytes and indexing returns ints, so the
        # bit reader and CRC helpers are agnostic to bytes vs mmap)
        with self.path.open("rb") as f:
            size = os.fstat(f.fileno()).st_size
            buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                   if size else b"")
        self.buf = buf
        with self.path.open("rb") as f:
            self.sinfo, self.audio_start = _read_streaminfo(f)
        if index is None:
            # "unknown length" streams need the full scan to learn the
            # total; everything else picks by size
            index = ("eager" if len(buf) <= _EAGER_INDEX_MAX
                     or self.sinfo["total"] == 0 else "lazy")
        self.index_mode = index
        self._cache = {}  # byte offset -> (samples, position, end)
        self.n_probe_scans = 0  # instrumentation: lazy-index probes
        if index == "lazy":
            import threading

            # instances are shared across threads through the _OPEN
            # cache (fulltrace overview thread + UI loader); the lazy
            # index mutates paired anchor lists, so reads serialize.
            # The eager index is immutable after __init__ and needs no
            # lock.
            self._lock = threading.Lock()
            self.offsets = None     # eager-only (full frame table)
            self.positions = None
            self._apos = []         # verified anchors: sorted positions
            self._aoff = []         # parallel byte offsets
            # anchor spacing: dense enough that a re-seek near a past
            # read is one chain hop, sparse enough to stay tiny
            self._stride = max(self.sinfo["max_blocksize"],
                               self.sinfo["total"] >> 12)
            # SEEKTABLE points seed the bisection (validated by decode
            # on first use; a corrupt table degrades to plain bisection)
            self._seeds = sorted(
                (int(s), self.audio_start + int(o))
                for s, o in self.sinfo.get("seekpoints", ())
                if 0 <= s < max(self.sinfo["total"], 1))
            return
        # eager: sync-code scan over the whole stream
        data = np.frombuffer(buf, np.uint8)
        cand = np.nonzero(data[self.audio_start : -1] == 0xFF)[0]
        cand = cand[(data[self.audio_start + cand + 1] & 0xFC) == 0xF8]
        offsets, positions = [], []
        for rel in cand:
            off = self.audio_start + int(rel)
            parsed = _parse_frame_header(buf, off, self.sinfo)
            if parsed is None:
                continue
            offsets.append(off)
            positions.append(parsed[4])
        if not offsets:
            if self.sinfo["total"] == 0:  # valid zero-length stream
                self.offsets = np.zeros(0, np.int64)
                self.positions = np.zeros(0, np.int64)
                return
            raise FlacError(f"{path}: no FLAC frames found")
        # a sync-scan false positive (random payload bytes that parse as
        # a header AND pass CRC-8 + streaminfo consistency) would poison
        # a greedy monotonic filter: one impostor with a huge coded
        # number makes every later REAL frame non-increasing.  Real
        # frames form the longest strictly-increasing position chain;
        # keep that chain (O(n log n) LIS) so isolated impostors drop
        # out instead of the rest of the file.
        keep = _longest_increasing(positions)
        self.offsets = np.asarray([offsets[i] for i in keep], np.int64)
        self.positions = np.asarray([positions[i] for i in keep],
                                    np.int64)
        if self.sinfo["total"] == 0 and len(self.offsets):
            # legal "unknown length" streams (piped encoders): derive
            # the total from the index + the last frame's header
            parsed = _parse_frame_header(buf, int(self.offsets[-1]),
                                         self.sinfo)
            self.sinfo["total"] = int(self.positions[-1]) + parsed[1]

    # -- shared frame decode (offset-keyed cache) --

    def _decode_at(self, off):
        """Decode the frame at byte ``off`` -> (samples, position, end).
        Raises FlacError on any parse/CRC failure."""
        hit = self._cache.get(off)
        if hit is None:
            from .. import native

            decode = getattr(native, "flac_decode_frame_meta", None)
            hit = decode(self.buf, off, self.sinfo) if decode else None
            if hit is None:  # no native library: Python reference path
                hit = _decode_frame(self.buf, off, self.sinfo)
            if len(self._cache) > 8:
                self._cache.clear()
            self._cache[off] = hit
        return hit

    def decode_frame(self, k):
        """Samples of the k-th indexed frame (eager index only)."""
        return self._decode_at(int(self.offsets[k]))[0]

    # -- lazy index machinery --

    def _maybe_anchor(self, pos, off):
        import bisect

        i = bisect.bisect_left(self._apos, pos)
        if i < len(self._apos) and self._apos[i] == pos:
            return
        near = ((i < len(self._apos)
                 and self._apos[i] - pos < self._stride)
                or (i > 0 and pos - self._apos[i - 1] < self._stride))
        if not near or not self._apos:
            self._apos.insert(i, pos)
            self._aoff.insert(i, off)

    def _scan_valid_frame(self, start_byte, limit_byte):
        """First decode-verified frame at byte >= ``start_byte``:
        ``(off, pos, end)`` or None.  Sync-scan false positives are
        rejected by the full-frame decode (header CRC-8 + streaminfo
        consistency + frame CRC-16), so an impostor header embedded in
        payload bytes cannot enter the index."""
        self.n_probe_scans += 1
        data = np.frombuffer(self.buf, np.uint8)
        b = max(int(start_byte), self.audio_start)
        limit_byte = min(int(limit_byte), len(data))
        while b < limit_byte:
            e = min(b + _SCAN_CHUNK, limit_byte)
            window = data[b : min(e + 1, len(data))]
            if len(window) < 2:
                break
            cand = np.nonzero(window[:-1] == 0xFF)[0]
            cand = cand[(window[cand + 1] & 0xFC) == 0xF8]
            for rel in cand:
                off = b + int(rel)
                if off >= limit_byte:
                    return None
                if _parse_frame_header(self.buf, off, self.sinfo) \
                        is None:
                    continue
                try:
                    _samples, pos, end = self._decode_at(off)
                except FlacError:
                    continue
                return off, pos, end
            b = e
        return None

    def _verify_seed(self, off):
        """Promote one SEEKTABLE point to a verified anchor; returns
        the decoded (pos, off) or None (corrupt point: dropped).  Only
        the DECODED position is trusted — a lying-but-decodable point
        still yields a correct anchor."""
        if _parse_frame_header(self.buf, off, self.sinfo) is None:
            return None
        try:
            _samples, pos, _end = self._decode_at(off)
        except FlacError:
            return None
        self._maybe_anchor(pos, off)
        return pos, off

    def _locate(self, start):
        """A decode-verified frame (off, pos) with pos <= ``start``
        (or the stream's first frame), found by byte bisection."""
        import bisect

        i = bisect.bisect_right(self._apos, start) - 1
        if i >= 0:
            lo_pos, lo_off = self._apos[i], self._aoff[i]
        else:
            got = self._scan_valid_frame(self.audio_start,
                                         len(self.buf))
            if got is None:
                raise FlacError(f"{self.path}: no FLAC frames found")
            lo_off, lo_pos, _end = got
            self._maybe_anchor(lo_pos, lo_off)
            if lo_pos >= start:
                return lo_off, lo_pos
        hi_b = len(self.buf)
        j = bisect.bisect_right(self._apos, start)
        if j < len(self._apos):
            hi_b = self._aoff[j]
        # consume the SEEKTABLE points bracketing the target (each is
        # decode-verified once, then lives on as a plain anchor)
        while self._seeds:
            k = bisect.bisect_right(self._seeds, (start, hi_b)) - 1
            took = False
            if k >= 0 and lo_pos < self._seeds[k][0] <= start:
                _sample, off = self._seeds.pop(k)
                got = self._verify_seed(off)
                took = True
                if got is not None and lo_pos < got[0] <= start:
                    lo_pos, lo_off = got
            elif k + 1 < len(self._seeds) \
                    and self._seeds[k + 1][1] < hi_b:
                _sample, off = self._seeds.pop(k + 1)
                got = self._verify_seed(off)
                took = True
                if got is not None and got[0] > start \
                        and off < hi_b:
                    hi_b = off
            if not took:
                break
        slack = _SEEK_SLACK_BLOCKS * self.sinfo["max_blocksize"]
        while (start - lo_pos > slack
               and hi_b - lo_off > _SEEK_MIN_BYTES):
            mid = (lo_off + hi_b) // 2
            got = self._scan_valid_frame(mid, hi_b)
            if got is None or got[1] > start:
                if got is not None:
                    self._maybe_anchor(got[1], got[0])
                hi_b = mid
            else:
                lo_off, lo_pos = got[0], got[1]
                self._maybe_anchor(lo_pos, lo_off)
        return lo_off, lo_pos

    # -- reads --

    def _read_into_lazy(self, start, nframes, out):
        end_target = start + nframes
        off, _pos = self._locate(start)
        last_pos = None
        while off is not None and off < len(self.buf):
            try:
                frame, fpos, fend = self._decode_at(off)
            except FlacError:
                # a corrupt frame wholly BEFORE the requested window is
                # not this read's problem (the eager path never decodes
                # it either): resync forward; only raise when the bad
                # frame overlaps [start, end_target)
                got = self._scan_valid_frame(off + 1, len(self.buf))
                if got is None or got[1] > start:
                    raise
                off = got[0]
                continue
            if last_pos is not None and fpos <= last_pos:
                raise FlacError(
                    f"{self.path}: non-monotonic frame chain at byte "
                    f"{off}")
            last_pos = fpos
            n = len(frame)
            a = max(fpos, start)
            b = min(fpos + n, end_target)
            if b > a:
                out[a - start : b - start] = frame[a - fpos : b - fpos]
            self._maybe_anchor(fpos, off)
            if fpos + n >= end_target or fend >= len(self.buf):
                break
            off = fend
        return out[:nframes]

    def read_into(self, start, nframes, out):
        """Fill ``out[:nframes]`` with decoded samples of
        [start, start+nframes) (any integer dtype; one cast copy per
        frame, no intermediate allocation)."""
        total = self.sinfo["total"]
        start = max(0, min(int(start), total))
        nframes = max(0, min(int(nframes), total - start))
        if nframes == 0:
            return out[:0]
        out[:nframes] = 0
        if self.offsets is None:
            with self._lock:
                return self._read_into_lazy(start, nframes, out)
        k = int(np.searchsorted(self.positions, start, side="right")) - 1
        k = max(k, 0)
        filled = 0
        while filled < nframes and k < len(self.offsets):
            frame = self.decode_frame(k)
            fpos = int(self.positions[k])
            lo = max(start + filled - fpos, 0)
            hi = min(len(frame), start + nframes - fpos)
            if hi > lo:
                out[fpos + lo - start : fpos + hi - start] = frame[lo:hi]
            filled = fpos + max(hi, 0) - start
            k += 1
        return out[:nframes]

    def read(self, start, nframes):
        """Decoded samples [start, start+nframes) as (n, ch) int64."""
        nframes = max(0, min(int(nframes),
                             self.sinfo["total"] - max(0, int(start))))
        return self.read_into(
            start, nframes,
            np.zeros((nframes, self.sinfo["channels"]), np.int64))


_OPEN = {}  # (path, mtime, size) -> _FlacFile (tiny LRU)


def _cache_key(p):
    st = p.stat()
    return (str(p), st.st_mtime_ns, st.st_size)


def _open(path):
    p = Path(path)
    key = _cache_key(p)
    ff = _OPEN.get(key)
    if ff is None:
        if len(_OPEN) > 4:
            _OPEN.clear()
        ff = _FlacFile(p)
        _OPEN[key] = ff
    return ff


def read_frames(path, start, nframes, info=None):
    """Frames [start, start+nframes) as float64 in [-1, 1) — the
    :func:`wavio.read_frames` contract (sample = k / 2**(bits-1))."""
    ff = _open(path)
    bits = ff.sinfo["bits"]
    return ff.read(start, nframes).astype(np.float64) / (1 << (bits - 1))


def read_frames_raw16(path, start, nframes, out):
    """Decode frames [start, start+nframes) of a 16-bit FLAC straight
    into ``out`` (C-contiguous int16 ``(>=nframes, channels)``) — the
    int16 device-upload fast path (`loader.read_raw16_into`): the
    decoded codes ARE the quantized values the device dequantizes as
    ``k / 2**15``, so the float64 decode + re-quantize round trip is
    skipped (several full host passes).  Returns
    the number of frames read."""
    ff = _open(path)
    if ff.sinfo["bits"] != 16:
        raise FlacError(f"{path}: raw16 read needs a 16-bit FLAC, got "
                        f"{ff.sinfo['bits']}")
    return len(ff.read_into(start, nframes, out))


def read_flac(path):
    """(data, rate): decode a whole FLAC file (float64 in [-1, 1))."""
    ff = _open(path)
    return (read_frames(path, 0, ff.sinfo["total"]),
            float(ff.sinfo["rate"]))


def flac_metadata(path):
    """VORBIS_COMMENT tags as a flat dict (empty when absent).

    Header-only (the scan_wav 'milliseconds' contract): the whole-file
    frame index is reused when already cached but never built here."""
    p = Path(path)
    try:
        ff = _OPEN.get(_cache_key(p))
    except OSError:
        ff = None
    if ff is not None:
        return dict(ff.sinfo["comments"])
    with p.open("rb") as f:
        info, _ = _read_streaminfo(f)
    return dict(info["comments"])


# -- encoder ---------------------------------------------------------------------


def _utf8_number(n):
    """FLAC's UTF-8-style coded frame number (1-7 bytes)."""
    if n < 0x80:
        return bytes([n])
    # nbytes continuation bytes carry 6 bits each; the lead byte carries
    # (6 - nbytes) payload bits
    nbytes = 1
    while nbytes < 6 and n >= (1 << ((6 - nbytes) + 6 * nbytes)):
        nbytes += 1
    lead = (0xFF << (7 - nbytes)) & 0xFF
    shift = 6 * nbytes
    out = [lead | (n >> shift)]
    for _ in range(nbytes):
        shift -= 6
        out.append(0x80 | ((n >> shift) & 0x3F))
    return bytes(out)


def _zigzag(res):
    """Rice's signed→unsigned mapping as uint64 (never negative)."""
    r = np.asarray(res, np.int64)
    return ((np.abs(r) << 1) - (r < 0)).astype(np.uint64)


_MAX_PARTITION_ORDER = 6


def _best_partitioned_rice(res, blocksize, order):
    """Best (method, partition_order, params, cost_bits) for a residual.

    Exhaustive over both coding methods (RICE, 4-bit params 0..14;
    RICE2, 5-bit params 0..30 — needed for >16-bit depths where
    residual magnitudes outgrow param 14), partition orders 0..6, and
    every legal Rice parameter per partition: per-parameter partition
    costs are built once at the finest legal order with
    ``np.add.reduceat`` and folded pairwise upward, so the search is
    O(31·nparts) numpy work — the search space libFLAC's default
    presets use."""
    u = _zigzag(res)
    n = len(u)
    max_po = 0
    while (max_po < _MAX_PARTITION_ORDER
           and blocksize % (1 << (max_po + 1)) == 0
           and (blocksize >> (max_po + 1)) > order):
        max_po += 1
    # quotient sums per (param, finest partition)
    nfine = 1 << max_po
    edges = np.arange(nfine, dtype=np.int64) * (blocksize >> max_po)
    edges[0] = 0
    edges[1:] -= order  # residual index space starts after the warm-up
    counts = np.diff(np.append(edges, n))
    psums = np.empty((31, nfine), np.float64)
    for p in range(31):
        q = u >> p
        psums[p] = np.add.reduceat(q, edges) if nfine > 1 else q.sum()
    best = None
    sums = psums
    cnts = counts.astype(np.float64)
    for po in range(max_po, -1, -1):
        for method, pmax, pbits in ((0, 15, 4), (1, 31, 5)):
            # per-partition best parameter at this order and width
            costs = (sums[:pmax]
                     + cnts[None, :] * (np.arange(pmax)[:, None] + 1.0))
            pick = np.argmin(costs, axis=0)
            total = float(costs[pick, np.arange(costs.shape[1])].sum())
            total += 2 + 4 + pbits * (1 << po)  # method+order+params
            if best is None or total < best[3]:
                best = (method, po, pick.tolist(), total)
        if po:
            sums = sums[:, 0::2] + sums[:, 1::2]
            cnts = cnts[0::2] + cnts[1::2]
    return best


def _write_residual(bw, res, blocksize, order, plan=None):
    if plan is None:
        plan = _best_partitioned_rice(res, blocksize, order)
    method, po, params, _cost = plan
    pbits = 4 if method == 0 else 5
    bw.write(method, 2)
    bw.write(po, 4)
    res = np.asarray(res, np.int64)
    idx = 0
    for p in range(1 << po):
        nsamp = (blocksize >> po) - (order if p == 0 else 0)
        param = int(params[p])
        bw.write(param, pbits)
        part = res[idx : idx + nsamp]
        idx += nsamp
        for v in part:
            v = int(v)
            u = (-v * 2 - 1) if v < 0 else (2 * v)
            bw.write_unary(u >> param)
            if param:
                bw.write(u & ((1 << param) - 1), param)


def _wasted_bits(x):
    """Common trailing-zero count over the block (0 when any sample is
    odd or the block is all zeros — all-zero goes CONSTANT anyway)."""
    nz = x[x != 0]
    if len(nz) == 0:
        return 0
    orred = int(np.bitwise_or.reduce(nz))
    return (orred & -orred).bit_length() - 1


def _fixed_residual(x, order):
    res = x[order:].copy()
    for j, c in enumerate(_FIXED_COEFS[order]):
        res -= c * x[order - 1 - j : len(x) - 1 - j]
    return res


_LPC_PRECISION = 15


def _quantize_lpc(coefs):
    """libFLAC-style coefficient quantization with error feedback.
    Returns (qcoefs int list, shift) for 15-bit precision."""
    cmax = float(np.max(np.abs(coefs)))
    if cmax <= 0.0:
        return None
    headroom = _LPC_PRECISION - 1 - int(np.floor(np.log2(cmax))) - 1
    shift = max(0, min(headroom, 15))
    err = 0.0
    q = []
    qmax = (1 << (_LPC_PRECISION - 1)) - 1
    qmin = -(1 << (_LPC_PRECISION - 1))
    for c in coefs:
        v = c * (1 << shift) + err
        qi = int(np.clip(round(v), qmin, qmax))
        err = v - qi
        q.append(qi)
    return q, shift


def _lpc_candidates(x, max_order):
    """Levinson-Durbin over a windowed autocorrelation; yields
    (order, float_coefs, predicted_bits_per_sample) for orders
    1..max_order.  The window only steers model selection — the encoded
    residual below is exact integer arithmetic."""
    n = len(x)
    if n <= max_order + 1:
        return []
    w = np.hanning(n)
    xf = x.astype(np.float64) * w
    ac = np.correlate(xf, xf, "full")[n - 1 : n + max_order]
    if ac[0] == 0.0:
        return []
    out = []
    err = ac[0]
    coefs = np.zeros(0)
    for m in range(1, max_order + 1):
        acc = ac[m] - (coefs @ ac[1:m][::-1] if m > 1 else 0.0)
        k = acc / err
        coefs = np.append(coefs - k * coefs[::-1], k) if m > 1 \
            else np.array([k])
        err *= 1.0 - k * k
        if err <= 0.0:
            break
        # ~0.5*log2 of the prediction-error variance = expected rice bps
        bps_est = max(0.5 * np.log2(err / n + 1e-30), 0.0)
        out.append((m, coefs.copy(), bps_est))
    return out


def _lpc_residual(x, qcoefs, shift):
    n = len(x)
    order = len(qcoefs)
    pred = np.zeros(n - order, np.int64)
    for j, c in enumerate(qcoefs):
        pred += c * x[order - 1 - j : n - 1 - j]
    return x[order:] - (pred >> shift)


class _SubframePlan:
    """A fully-decided subframe encoding: type, predictor, residual and
    its partition plan, wasted bits, and the exact bit cost (used for
    the per-frame stereo-decorrelation decision)."""

    __slots__ = ("kind", "x", "bps", "wasted", "order", "qcoefs",
                 "shift", "res", "rice", "cost")

    def __init__(self, kind, x, bps, wasted, cost, order=0, qcoefs=None,
                 shift=0, res=None, rice=None):
        self.kind = kind
        self.x = x
        self.bps = bps
        self.wasted = wasted
        self.cost = cost
        self.order = order
        self.qcoefs = qcoefs
        self.shift = shift
        self.res = res
        self.rice = rice


def _plan_subframe(x, bps, max_lpc_order):
    """Choose the cheapest encoding for one subframe's samples."""
    x = np.asarray(x, np.int64)
    n = len(x)
    head = 1 + 6 + 1  # padding + type + wasted flag
    if n and np.all(x == x[0]):
        return _SubframePlan("constant", x, bps, 0, head + bps)
    wasted = _wasted_bits(x)
    if wasted:
        x = x >> wasted
        bps -= wasted
        head += wasted  # unary wasted-count costs `wasted` bits
    best = _SubframePlan("verbatim", x, bps, wasted, head + n * bps)
    for order in range(min(4, n - 1) + 1):
        res = _fixed_residual(x, order)
        rice = _best_partitioned_rice(res, n, order)
        cost = head + order * bps + rice[3]
        if cost < best.cost:
            best = _SubframePlan("fixed", x, bps, wasted, cost,
                                 order=order, res=res, rice=rice)
    if max_lpc_order and n > max_lpc_order + 1:
        cands = _lpc_candidates(x, max_lpc_order)
        if cands:
            # probe the analytically best order and the full order
            est_best = min(cands, key=lambda c: c[2] * (n - c[0])
                           + c[0] * bps)
            probes = {est_best[0], cands[-1][0]}
            for order, coefs, _bps_est in cands:
                if order not in probes:
                    continue
                quant = _quantize_lpc(coefs)
                if quant is None:
                    continue
                qcoefs, shift = quant
                res = _lpc_residual(x, qcoefs, shift)
                rice = _best_partitioned_rice(res, n, order)
                cost = (head + order * bps + 4 + 5
                        + order * _LPC_PRECISION + rice[3])
                if cost < best.cost:
                    best = _SubframePlan(
                        "lpc", x, bps, wasted, cost, order=order,
                        qcoefs=qcoefs, shift=shift, res=res, rice=rice)
    return best


def _write_subframe(bw, plan, blocksize):
    bw.write(0, 1)
    if plan.kind == "constant":
        bw.write(0, 6)
    elif plan.kind == "verbatim":
        bw.write(1, 6)
    elif plan.kind == "fixed":
        bw.write(8 + plan.order, 6)
    else:
        bw.write(32 + plan.order - 1, 6)
    if plan.wasted:
        bw.write(1, 1)
        bw.write_unary(plan.wasted - 1)
    else:
        bw.write(0, 1)
    if plan.kind == "constant":
        bw.write(int(plan.x[0]), plan.bps)
        return
    if plan.kind == "verbatim":
        for v in plan.x:
            bw.write(int(v), plan.bps)
        return
    for v in plan.x[: plan.order]:
        bw.write(int(v), plan.bps)
    if plan.kind == "lpc":
        bw.write(_LPC_PRECISION - 1, 4)
        bw.write(plan.shift, 5)
        for c in plan.qcoefs:
            bw.write(c, _LPC_PRECISION)
    _write_residual(bw, plan.res, blocksize, plan.order, plan.rice)


def _seektable_layout(n, rate, blocksize):
    """``(span, npoints)`` for a SEEKTABLE over ``n`` samples: one point
    every ~10 s (the ``flac`` CLI's default template) snapped to the
    fixed frame grid, capped at 4096 points for very long recordings."""
    if n <= 0:
        return 0, 0
    span = max(blocksize, int(round(10.0 * float(rate))))
    span = -(-span // blocksize) * blocksize
    npts = -(-n // span)
    if npts > 4096:
        span = -(-(-(-n // 4096)) // blocksize) * blocksize
        npts = -(-n // span)
    return span, npts


def _insert_metadata_block(blob, btype, body):
    """Insert a metadata block after the existing blocks of a complete
    FLAC stream; the new block becomes the last one.  Used to splice
    host-side blocks (VORBIS_COMMENT tags) into the native encoder's
    output without assuming which blocks it emitted."""
    if blob[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    pos = 4
    while True:
        hdr = blob[pos]
        size = int.from_bytes(blob[pos + 1 : pos + 4], "big")
        end = pos + 4 + size
        if hdr & 0x80:
            break
        pos = end
    out = bytearray(blob)
    out[pos] = hdr & 0x7F  # the old last block no longer is
    out[end:end] = (bytes([0x80 | btype])
                    + len(body).to_bytes(3, "big") + bytes(body))
    return bytes(out)


def _vorbis_comment(tags):
    """A VORBIS_COMMENT block body from flattened (key, value) tags."""
    vendor = b"audian-tpu"
    vc = struct.pack("<I", len(vendor)) + vendor
    vc += struct.pack("<I", len(tags))
    for key, value in tags:
        entry = f"{key}={value}".encode("utf-8")
        vc += struct.pack("<I", len(entry)) + entry
    return vc


def _flatten_md(md, prefix=""):
    out = []
    for key, value in (md or {}).items():
        if isinstance(value, dict):
            out += _flatten_md(value, f"{prefix}{key}.")
        else:
            out.append((f"{prefix}{key}", str(value)))
    return out


def _quantize(data, bits):
    """Input samples → raw int64 at ``bits`` depth.

    Integer input passes through unchanged (depth asserted); float is
    scaled by 2**(bits-1) — the inverse of :func:`read_frames`."""
    if np.issubdtype(data.dtype, np.integer):
        q = data.astype(np.int64)
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        if len(q) and (q.min() < lo or q.max() > hi):
            raise FlacError(f"integer samples exceed {bits}-bit range")
        return q
    scale = float(1 << (bits - 1))
    return np.clip(np.round(np.asarray(data, np.float64) * scale),
                   -scale, scale - 1).astype(np.int64)


_SS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def write_flac(path, data, rate, blocksize=4096, metadata=None,
               bits=None, max_lpc_order=8):
    """Encode ``data`` (shape (n,) or (n, ch)) as a FLAC file.

    ``bits`` selects the stored depth (8/12/16/20/24/32; default 16 for
    float input, the dtype's width for int16/int32 input — int32 stores
    24-bit unless ``bits`` says otherwise, matching the loaders' PCM_24
    convention).  Float samples are quantized at ``2**(bits-1)`` (the
    inverse of :func:`read_frames`).  Per subframe the encoder picks the
    cheapest of CONSTANT / VERBATIM / FIXED(0-4) / LPC(≤``max_lpc_order``,
    Levinson-Durbin, 15-bit quantized coefficients) with partitioned
    Rice residuals and wasted-bits packing; stereo frames additionally
    pick the best of independent / left-side / right-side / mid-side.
    A SEEKTABLE (one point every ~10 s on the frame grid, the ``flac``
    CLI's default template) makes random access on the decode side
    O(log n) without a sync scan.
    STREAMINFO carries the true MD5 of the unencoded samples, so
    ``flac -t`` / ``ffmpeg`` integrity checks pass.  ``metadata`` (a
    possibly nested dict) is stored as VORBIS_COMMENT tags (nested keys
    dotted).  Reference parity: region export at source depth through
    libsndfile, `/root/reference/src/audian/databrowser.py:1860-1921`."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    if bits is None:
        if data.dtype == np.int16:
            bits = 16
        elif data.dtype == np.int32:
            bits = 24
        elif np.issubdtype(data.dtype, np.integer):
            bits = 16 if data.dtype.itemsize <= 2 else 24
        else:
            bits = 16
    bits = int(bits)
    if bits not in _SS_CODES:
        raise FlacError(f"unsupported FLAC bit depth {bits}")
    blocksize = int(blocksize)
    if not 16 <= blocksize <= 65535:
        # the frame header's 8/16-bit blocksize fields and STREAMINFO's
        # 16-bit min/max cap legal blocksizes at 16..65535; _BitWriter
        # masks silently, so an out-of-range value would emit a corrupt
        # stream instead of an error (the native encoder rejects too)
        raise FlacError(
            f"blocksize {blocksize} outside the FLAC-legal 16..65535")
    q = _quantize(data, bits)
    n, channels = q.shape
    if not 1 <= channels <= 8:
        raise FlacError(f"unsupported channel count {channels}")
    rate = int(round(float(rate)))
    tags = _flatten_md(metadata)
    # production path: the C++ encoder (flacenc.cc — identical design,
    # ~2 orders of magnitude faster); this Python encoder below is the
    # readable reference and the no-compiler fallback.  Tags are
    # spliced in after STREAMINFO (bytes 4..41) host-side.
    from .. import native

    blob = (native.flac_encode(q, rate, bits, blocksize, max_lpc_order)
            if 16 <= blocksize <= 32768 else None)
    if blob is not None:
        if tags:
            blob = _insert_metadata_block(blob, 4, _vorbis_comment(tags))
        Path(path).write_bytes(blob)
        return Path(path)
    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    width = (bits + 7) // 8
    if width == 3:  # 24-bit: low 3 little-endian bytes of each sample
        le = np.ascontiguousarray(q.astype("<i4"))
        raw = le.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        raw = q.astype(f"<i{width}").tobytes()
    body = si.out + hashlib.md5(raw).digest()
    span, npts = _seektable_layout(n, rate, blocksize)
    last_flag = 0x80 if not tags and not npts else 0x00
    out += bytes([last_flag]) + len(body).to_bytes(3, "big") + bytes(body)
    st_base = None
    if npts:
        # placeholder points (sample = all-ones), patched per frame
        out += (bytes([(0x00 if tags else 0x80) | 3])
                + (18 * npts).to_bytes(3, "big"))
        st_base = len(out)
        out += (b"\xFF" * 8 + b"\x00" * 10) * npts
    if tags:
        vc = _vorbis_comment(tags)
        out += bytes([0x80 | 4]) + len(vc).to_bytes(3, "big") + vc
    audio_start = len(out)
    ss_code = _SS_CODES[bits]
    for fnum, pos in enumerate(range(0, n, blocksize)):
        block = q[pos : pos + blocksize]
        bs = len(block)
        if st_base is not None and pos % span == 0 and pos // span < npts:
            rec = struct.pack(">QQH", pos, len(out) - audio_start, bs)
            k = st_base + 18 * (pos // span)
            out[k : k + 18] = rec
        # per-frame channel assignment: independent always; for stereo
        # also left/side, right/side, mid/side (decoder inverse at
        # _decode_frame; side carries one extra bit)
        plans = [_plan_subframe(block[:, c], bits, max_lpc_order)
                 for c in range(channels)]
        ca = channels - 1
        if channels == 2:
            left = block[:, 0]
            right = block[:, 1]
            side = left - right
            mid = (left + right) >> 1
            p_side = _plan_subframe(side, bits + 1, max_lpc_order)
            p_mid = _plan_subframe(mid, bits, max_lpc_order)
            combos = [
                (1, plans[0].cost + plans[1].cost, plans),
                (8, plans[0].cost + p_side.cost, [plans[0], p_side]),
                (9, p_side.cost + plans[1].cost, [p_side, plans[1]]),
                (10, p_mid.cost + p_side.cost, [p_mid, p_side]),
            ]
            ca, _cost, plans = min(combos, key=lambda t: t[1])
        hdr = _BitWriter()
        hdr.write(0x3FFE, 14)
        hdr.write(0, 1)
        hdr.write(0, 1)          # fixed blocking strategy
        full = bs == blocksize and blocksize in (
            256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
        if full:
            hdr.write({256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                       8192: 13, 16384: 14, 32768: 15}[blocksize], 4)
        else:
            hdr.write(7, 4)      # 16-bit blocksize-1 at header end
        hdr.write(0, 4)          # sample rate from STREAMINFO
        hdr.write(ca, 4)
        hdr.write(ss_code, 3)
        hdr.write(0, 1)
        for b in _utf8_number(fnum):
            hdr.write(b, 8)
        if not full:
            hdr.write(bs - 1, 16)
        hdr.align()
        head = bytes(hdr.out)
        frame = bytearray(head)
        frame.append(_crc8(head))
        bw = _BitWriter()
        for plan in plans:
            _write_subframe(bw, plan, bs)
        bw.align()
        frame += bw.bytes()
        frame += _crc16(frame).to_bytes(2, "big")
        out += frame
    Path(path).write_bytes(bytes(out))
    return Path(path)
