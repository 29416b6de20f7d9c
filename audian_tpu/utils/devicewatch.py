"""Device-loss watchdog for the interactive session.

A device can stop answering in two ways: backend init hangs, or — worse
for a live session — ``jax.devices()`` answers but every device op
hangs.  The reference can never hang this way: its hot loop is pure host scipy
(`/root/reference/src/audian/databrowser.py:1126-1314`).  To match that
robustness, every device-facing transfer in the interactive path runs
through :meth:`DeviceWatch.pull`:

* the transfer runs on a worker thread while the watchdog waits;
* if it takes long, a tiny heartbeat op probes the device from another
  thread — device execution stays live from other threads while a
  *compile* is in flight, so a slow-but-alive device keeps the wait
  going, while a dead device fails the heartbeat and the pull raises
  :class:`DeviceLost`;
* once lost, further pulls raise immediately (no per-call timeouts) and
  a background thread re-probes until the device answers again, then
  flips the state back and notifies listeners.

Callers (``data/data.py`` window updates, ``view/render.py`` tile
pulls) catch :class:`DeviceLost` and serve the session from the host
scipy path (`GraphExecutor.run_host`); both frontends surface
"device lost — host mode" through ``DataBrowser.device_state``.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

__all__ = ["DeviceLost", "DeviceWatch", "watch"]


class DeviceLost(RuntimeError):
    """The device stopped answering; serve host mode."""


import atexit

_shutdown = False


def _mark_shutdown():
    global _shutdown
    _shutdown = True


atexit.register(_mark_shutdown)


_probe_fn = None


def _default_probe():
    """One tiny COMPILED device op + scalar pull — the liveness signal.
    Compiled-op execution stays live from other threads while a compile
    is in flight, but fresh compiles (and, on some runtimes, bare
    ``device_put`` transfers) serialize behind an in-flight compile, so
    a transfer or eager probe could block for the whole of a
    first-session chain compile and falsely mark a healthy device
    lost.  So the probe must be compiled ONCE, as early as possible —
    :meth:`DeviceWatch.warm_async` runs it at session open, before the
    first chain compile, and the persistent compilation cache makes
    later sessions instant.  An unwarmed first probe racing a big chain
    compile is covered by ``first_heartbeat_timeout``."""
    global _probe_fn
    import jax
    import jax.numpy as jnp

    if _probe_fn is None:
        _probe_fn = jax.jit(lambda x: jnp.sum(x * 1.000001))
    return float(np.asarray(_probe_fn(jnp.ones((8, 8),
                                               jnp.float32)))) > 0.0


class DeviceWatch:
    """Guarded device access with heartbeat-based loss detection.

    Parameters (also settable per instance; environment overrides):

    - ``patience``: seconds a pull may run before heartbeats start
      (``AUDIAN_TPU_PULL_PATIENCE``, default 5).
    - ``heartbeat_timeout``: seconds one heartbeat op may take before
      the device is declared lost (``AUDIAN_TPU_HEARTBEAT_TIMEOUT``,
      default 20 — warm heartbeats answer in well under a second even
      while a compile is in flight).
    - ``first_heartbeat_timeout``: deadline for the very first probe.
      If the probe's own tiny compile queues behind a big in-flight
      chain compile (XLA compiles serialize), the probe answers only
      after that compile finishes — a fresh process's first chain
      compile can take minutes, so the unwarmed deadline must cover it (``AUDIAN_TPU_FIRST_HEARTBEAT_TIMEOUT``, default
      300).  After one successful probe the tight deadline applies.
    - ``reprobe_interval``: seconds between background recovery probes
      while lost (default 15).
    """

    def __init__(self, probe=None):
        self.patience = float(os.environ.get(
            "AUDIAN_TPU_PULL_PATIENCE", 5.0))
        self.heartbeat_timeout = float(os.environ.get(
            "AUDIAN_TPU_HEARTBEAT_TIMEOUT", 20.0))
        self.first_heartbeat_timeout = float(os.environ.get(
            "AUDIAN_TPU_FIRST_HEARTBEAT_TIMEOUT", 300.0))
        self.reprobe_interval = 15.0
        self._probe = probe or _default_probe
        self._probe_warmed = False
        self._warm_thread = None
        self._lost = False
        self._lock = threading.Lock()
        self._listeners = []
        self._reprobe_thread = None
        self._probe_lock = threading.Lock()
        self._pending_probe = None

    # -- state ---------------------------------------------------------------

    @property
    def lost(self):
        return self._lost

    def add_listener(self, cb):
        """``cb(lost: bool)`` fires on every state flip.  Called from
        watchdog threads — implementations must only set flags/post
        events, never touch GUI objects directly."""
        if cb not in self._listeners:
            self._listeners.append(cb)

    def remove_listener(self, cb):
        if cb in self._listeners:
            self._listeners.remove(cb)

    def _notify(self, lost):
        for cb in list(self._listeners):
            try:
                cb(lost)
            except Exception:
                pass

    def mark_lost(self, reason=""):
        with self._lock:
            if self._lost:
                return
            self._lost = True
        self._notify(True)
        self._start_reprobe()

    def mark_ok(self):
        with self._lock:
            if not self._lost:
                return
            self._lost = False
        # a probe still blocked from the outage era must not poison the
        # healthy era's liveness checks — the next check gets a fresh op
        with self._probe_lock:
            self._pending_probe = None
        self._notify(False)

    # -- probing -------------------------------------------------------------

    def _probe_alive(self, timeout=None):
        """Run one probe op on a worker thread; True iff it answered
        (and answered truthfully) within the deadline.  The first probe
        of a process gets the generous compile-inclusive deadline.

        At most ONE probe op is in flight at a time: while an earlier
        probe is still blocked inside the runtime (the hung-device
        outage mode), later calls wait on IT instead of stacking fresh
        threads — the documented 10+ hour outages would otherwise leak
        a thread (plus one queued device op, all replayed at recovery)
        per ~35 s reprobe cycle.  When the device answers again, the single
        blocked probe completes and its answer counts."""
        if timeout is None:
            timeout = (self.heartbeat_timeout if self._probe_warmed
                       else self.first_heartbeat_timeout)
        with self._probe_lock:
            pend = self._pending_probe
            if pend is None or pend["done"].is_set():
                pend = {"done": threading.Event(), "ok": False}

                def run():
                    try:
                        pend["ok"] = bool(self._probe())
                    except Exception:
                        pend["ok"] = False
                    finally:
                        pend["done"].set()

                threading.Thread(target=run, daemon=True,
                                 name="audian-heartbeat").start()
                self._pending_probe = pend
        alive = bool(pend["done"].wait(timeout) and pend["ok"])
        if alive:
            self._probe_warmed = True
        return alive

    def warm_async(self):
        """Public warm hook: sessions call this at open, BEFORE their
        first chain compile, so the probe's tiny compile wins the race
        for the compile lock and heartbeats are warm from the start."""
        self._warm_probe_async()

    def _warm_probe_async(self):
        """Compile the probe in the background so the first REAL
        heartbeat is already warm (its compile would otherwise eat most
        of the first-heartbeat deadline)."""
        if self._probe_warmed:
            return
        t = self._warm_thread
        if t is not None and t.is_alive():
            return

        def run():
            try:
                if bool(self._probe()):
                    self._probe_warmed = True
            except Exception:
                pass

        self._warm_thread = threading.Thread(
            target=run, daemon=True, name="audian-heartbeat-warm")
        self._warm_thread.start()

    def _start_reprobe(self):
        t = self._reprobe_thread
        if t is not None and t.is_alive():
            return

        def loop():
            while self._lost and not _shutdown:
                time.sleep(self.reprobe_interval)
                if not self._lost or _shutdown:
                    break
                if self._probe_alive():
                    self.mark_ok()
                    break

        self._reprobe_thread = threading.Thread(
            target=loop, daemon=True, name="audian-devicewatch-reprobe")
        self._reprobe_thread.start()

    # -- guarded access --------------------------------------------------------

    def pull(self, thunk, what="device op"):
        """Run ``thunk`` (a device transfer/dispatch) under the watchdog.

        Returns the thunk's result.  Raises :class:`DeviceLost` when the
        device is already lost, or becomes unresponsive while the thunk
        runs (the hung worker thread is abandoned — it is blocked inside
        the runtime and will die with the process).  Exceptions from the
        thunk propagate unchanged — EXCEPT a jax runtime error raised
        while the heartbeat is also dead (the device died by failing
        calls instead of hanging): that is the same outage in
        a different shape, so it becomes :class:`DeviceLost` and the
        callers' host fallbacks engage.
        """
        if self._lost:
            raise DeviceLost(f"device lost ({what})")
        box = {}
        done = threading.Event()

        def run():
            try:
                box["value"] = thunk()
            except BaseException as e:  # noqa: BLE001 - reraised below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True, name="audian-pull")
        t.start()
        # start compiling the probe in the background on the first
        # guarded pull: by the time a heartbeat is actually needed it
        # is warm, so the tight deadline applies
        self._warm_probe_async()
        if not done.wait(self.patience):
            # slow: distinguish "device busy/compiling" (heartbeats
            # answer) from "device dead" (heartbeat hangs too)
            while not done.wait(0.0):
                if not self._probe_alive():
                    self.mark_lost(f"heartbeat timeout during {what}")
                    raise DeviceLost(
                        f"device lost during {what} (heartbeat timed "
                        "out)")
                if done.wait(self.patience):
                    break
        if "error" in box:
            err = box["error"]
            if self._is_device_death(err):
                self.mark_lost(f"runtime error with dead heartbeat "
                               f"during {what}")
                raise DeviceLost(
                    f"device lost during {what}: {err}") from err
            raise err
        return box["value"]

    def _is_device_death(self, err):
        """A jax/XLA RUNTIME error whose follow-up probe also fails is
        the connection-reset flavor of an outage; a runtime error with
        a healthy heartbeat is a program error and stays the caller's
        problem."""
        import jax

        rte = getattr(jax.errors, "JaxRuntimeError", None)
        if rte is None or not isinstance(err, rte):
            return False
        return not self._probe_alive()


#: process-wide singleton the interactive session guards through
watch = DeviceWatch()
