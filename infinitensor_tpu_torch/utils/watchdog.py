"""Babysitter for long-running processes (counterpart of
infinitensor_tpu/utils/watchdog.py; processes and signals only).

A child process can hang with no output: a device runtime stuck at its
first call, a deadlocked worker. Reference analog: the CUDA runtime
rebuilds its stream and rebinds handles on capture failure (reference
src/cuda/cuda_runtime.cc:226-281); here the recovery unit is the whole
process.

`babysit(argv)` runs argv as a monitored child: any stdout/stderr line
resets the silence clock; a child silent for `quiet_s` is killed, an idle
gap is sat out, and the child is retried. Child stdout is forwarded
verbatim (JSON artifact lines survive). SIGTERM/SIGINT on the parent reap
the child so a `timeout` wrapper cannot orphan a device-holding process.

Callers emit heartbeat lines (anything, e.g. '# device ready') often
enough that a healthy run is never silent for quiet_s.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time


def babysit(argv: list, quiet_s: float = 600.0, gap_s: float = 420.0,
            attempts: int = 2, env: dict | None = None,
            fast_fail_s: float = 45.0) -> int:
    """Run argv under wedge supervision; returns the child's final rc.

    A child that exits nonzero on its own within ``fast_fail_s`` seconds
    (not a silence-kill) is a deterministic failure — import error, bad
    flag — that never held the device: fail fast instead of sitting out
    the idle gap and retrying (the gap exists only to let the device
    recover after a process that held it)."""
    env = dict(os.environ if env is None else env)
    rc = 1
    live: list = []

    def _reap(signum, frame):
        for c in live:
            c.kill()
        sys.exit(128 + signum)

    old_term = signal.signal(signal.SIGTERM, _reap)
    old_int = signal.signal(signal.SIGINT, _reap)
    try:
        for attempt in range(1, attempts + 1):
            started = time.time()
            last = [time.time()]
            child = subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, bufsize=1)
            live[:] = [child]

            def pump(src, dst):
                for line in src:
                    last[0] = time.time()
                    print(line, end="", file=dst, flush=True)

            threads = [
                threading.Thread(target=pump,
                                 args=(child.stdout, sys.stdout),
                                 daemon=True),
                threading.Thread(target=pump,
                                 args=(child.stderr, sys.stderr),
                                 daemon=True)]
            for t in threads:
                t.start()
            wedged = False
            while child.poll() is None:
                time.sleep(min(5.0, quiet_s / 4))
                if time.time() - last[0] > quiet_s:
                    wedged = True
                    print(f"# watchdog: child pid {child.pid} silent "
                          f"{quiet_s:.0f}s (wedged); killing",
                          file=sys.stderr, flush=True)
                    child.kill()
                    break
            child.wait()
            for t in threads:
                t.join(timeout=5)
            rc = child.returncode
            if rc == 0:
                return 0
            if not wedged and time.time() - started < fast_fail_s:
                print(f"# watchdog: child rc={rc} in "
                      f"{time.time() - started:.1f}s (deterministic fast "
                      "failure, never held the device); not retrying",
                      file=sys.stderr, flush=True)
                return rc
            if attempt < attempts:
                print(f"# watchdog: attempt {attempt} rc={rc}"
                      f"{' (wedged)' if wedged else ''}; sleeping "
                      f"{gap_s:.0f}s idle gap before retry",
                      file=sys.stderr, flush=True)
                time.sleep(gap_s)
        return rc if rc else 1
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def self_babysit(child_flag: str, quiet_env: str = "WATCHDOG_QUIET_S",
                 gap_env: str = "WATCHDOG_GAP_S",
                 attempts_env: str = "WATCHDOG_ATTEMPTS") -> None:
    """Call at the top of a device tool's __main__: re-exec this script as a
    monitored child unless `child_flag` is already set (or WATCHDOG=0)."""
    if os.environ.get("WATCHDOG", "1") != "1" or os.environ.get(child_flag):
        return
    env = dict(os.environ)
    env[child_flag] = "1"
    sys.exit(babysit(
        [sys.executable, os.path.abspath(sys.argv[0])] + sys.argv[1:],
        quiet_s=float(os.environ.get(quiet_env, "600")),
        gap_s=float(os.environ.get(gap_env, "420")),
        attempts=int(os.environ.get(attempts_env, "2")),
        env=env))
