"""File-level data parallelism for the batch CLIs.

The reference parallelizes batch work with a host multiprocessing pool
striding blocks of one file (`src/audian/compresseddata.py:104-122`);
directories of recordings are processed strictly sequentially
(`songdetector.py:745-771`).  On a multi-device host the natural unit is
one recording per device: every file's dense DSP (filter/envelope/spectrogram/
min-max) is dispatched onto its assigned device, and the host-side event
logic for different files overlaps with device compute of the others.

``map_files`` is the dispatch point used by ``audian-songdetector`` and
``audian-compress``: a thread per device, each thread pinning JAX's
(thread-local) default device, files handed out round-robin.  There is no
cross-file communication, so this composes with the in-file sharding of
:class:`ShardedPipeline` (give each worker its own sub-mesh) when single
recordings are long enough to shard.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax

__all__ = ["map_files"]


def map_files(fn, files, devices=None, max_workers=None, verbose=0):
    """Apply ``fn(path) -> result`` to every file, data-parallel across
    devices.

    Parameters
    ----------
    fn : callable taking a file path; its jitted/dense work runs on the
        worker's device (JAX's default-device config is thread-local).
    files : sequence of paths.
    devices : explicit device list (default: all ``jax.devices()``).
    max_workers : cap on concurrent files (default: one per device).
    verbose : print a dispatch line per file.

    Returns the list of results in input order.  Exceptions propagate
    after all submitted work finishes; like the reference's per-file error
    handling (`src/audian/audian.py:1349-1356`), a failing file does not
    abort the others — failures are gathered and the first is re-raised
    once every file has run.  A failure is something ``fn`` RAISES; an
    exception object ``fn`` returns as a value is an ordinary result.
    """
    files = list(files)
    if devices is None:
        devices = jax.devices()
    if not files:
        return []
    nw = max_workers or len(devices)
    nw = max(1, min(nw, len(files)))

    def guarded(path):
        # private failure sentinel (not the raw Exception type, which a
        # per-file error-report fn could legitimately RETURN)
        try:
            return (True, fn(path))
        except Exception as exc:
            return (False, exc)

    if nw == 1:
        # same gather-then-reraise semantics as the threaded path: a
        # failing file must not abort the others
        results = [guarded(f) for f in files]
    else:
        counter = itertools.count()
        lock = threading.Lock()
        slot = threading.local()

        def worker(path):
            if not hasattr(slot, "dev"):
                with lock:
                    slot.dev = devices[next(counter) % len(devices)]
            if verbose:
                print(f"  [{slot.dev}] {path}", flush=True)
            with jax.default_device(slot.dev):
                return guarded(path)

        with ThreadPoolExecutor(max_workers=nw) as pool:
            results = list(pool.map(worker, files))
    for ok, r in results:
        if not ok:
            raise r
    return [r for _ok, r in results]
