"""Progress watchdog for long-running entry points (a copy of
``pdunet_tpu/utils/watchdog.py``, standard library only, kept so the port
imports nothing of the JAX package).

A daemon thread aborts the process (exit code 87) when no heartbeat has
landed for ``timeout_s`` seconds, so a wedged build or device call costs a
bounded time instead of a job's whole allotment; queue scripts treat exit
87 as "retry once".

Heartbeats come from the hot loops (``bench`` per timed row); ``beat()`` is
a no-op until ``start()`` arms the watchdog, so library users never pay
for it.
"""

from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["start", "beat", "WATCHDOG_EXIT_CODE"]

#: distinct exit code so queue scripts can tell "wedged, retry" from a crash
WATCHDOG_EXIT_CODE = 87

_state: list | None = None  # [last_beat_monotonic, any_beat_yet] once armed


def beat() -> None:
    """Record forward progress. Cheap no-op unless start() armed the dog."""
    if _state is not None:
        _state[0] = time.monotonic()
        _state[1] = True


def start(timeout_s: float, label: str = "") -> None:
    """Arm the watchdog: abort the process if ``beat()`` stays silent for
    ``timeout_s`` seconds — 2× that before the FIRST beat, because the
    first window must also cover cold kernel builds (a healthy build must
    not be indistinguishable from a wedge at the steady-state timeout)."""
    global _state
    if timeout_s <= 0:
        return
    _state = [time.monotonic(), False]

    def _watch() -> None:
        while True:
            time.sleep(min(30.0, timeout_s / 4))
            stale = time.monotonic() - _state[0]
            limit = timeout_s if _state[1] else 2.0 * timeout_s
            if stale > limit:
                print(
                    f"[watchdog] no progress for {stale:.0f}s"
                    f"{' in ' + label if label else ''} — aborting "
                    f"(exit {WATCHDOG_EXIT_CODE})",
                    file=sys.stderr, flush=True,
                )
                # os._exit: the main thread may be blocked inside a wedged
                # device call that never returns, so normal interpreter
                # shutdown (sys.exit in a daemon thread) would not fire
                os._exit(WATCHDOG_EXIT_CODE)

    threading.Thread(target=_watch, daemon=True, name="pdunet-watchdog").start()
