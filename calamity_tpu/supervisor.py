"""Elastic supervision for long-running calibrations.

The reference has no failure handling beyond skipping low-quality
poltimes (SURVEY §5: "Failure detection / elastic recovery: none");
its fits are short enough that a crash means rerunning one (time, pol).
This framework's flagship configuration is different: a full-array
many-poltime batched descent is a multi-hour run, and a device or
transport failure mid-segment (``jax.errors.JaxRuntimeError:
UNAVAILABLE: ...``) leaves the backend unusable in-process.

Recovery model: the checkpointed drivers already persist the FULL
descent state every ``checkpoint_every`` steps and resume bit-exactly
(solver.checkpoint, parallel.batched.batched_fit_checkpointed), so the
correct recovery domain is the PROCESS — a crashed jax backend cannot be
re-initialized in-process. The supervisor runs the calibration command
as a child process, classifies its failures, waits for the device to
answer a tiny subprocess probe again, and relaunches; the relaunched
child picks up from the latest checkpoint (``resume`` defaults to True
in every driver). Infrastructure outages become delays, not failures.

Usage:
    python -m calamity_tpu.supervisor [options] -- \
        python examples/hera_full_demo.py --time_parallel \
            --checkpoint_dir /ckpt --ntimes 8

The supervised command MUST be resume-safe (``--checkpoint_dir`` set);
the supervisor itself never initializes a jax backend in-process — a
JAX process reserves most of a GPU's memory when it starts, so a
supervisor holding the device would starve its own child. Probes run in
short-lived subprocesses for the same reason (and so a wedged backend
can be abandoned by timeout).
"""

from __future__ import annotations

import datetime
import subprocess
import sys
import time

# appended to the captured tail when the supervisor kills a silent child
HANG_MARKER = "supervisor: child produced no output"

# Failure signatures that indicate the DEVICE or its transport died —
# retryable once the device answers probes again. Anything else (python
# exceptions, bad flags, OOM in our own host code) is a real failure and
# must surface immediately rather than loop.
TRANSIENT_PATTERNS = (
    "UNAVAILABLE:",
    "StatusCode.UNAVAILABLE",
    "Socket closed",
    "Connection reset by peer",
    "failed to connect to all addresses",
    "DEADLINE_EXCEEDED",
    HANG_MARKER,
)

# Failure signatures retried AT MOST ONCE per supervised run: a device-
# memory ResourceExhausted immediately after a crash/restart can be stale
# allocation residue (another process still releasing the device) rather
# than a genuinely oversized program. One relaunch (resuming from the
# checkpoint) disambiguates — a second identical failure is treated as
# real and surfaces. Deterministic
# program-too-big failures therefore cost one extra launch, never a loop.
RETRY_ONCE_PATTERNS = ("RESOURCE_EXHAUSTED", "ResourceExhausted")

# classification looks only at the END of the output: the fatal error is
# the last thing a dying child prints, while RECOVERED transport warnings
# (retry chatter mentioning UNAVAILABLE) can sit anywhere earlier in
# a long run's log without making its final, deterministic error retryable
CLASSIFY_TAIL_BYTES = 8192

_PROBE_SRC = """
import jax, jax.numpy as jnp, time
x = jnp.full((128, 128), float(time.time() % 1000.0), jnp.float32)
print(float(jnp.sum(x @ x)))
"""


def is_transient_device_failure(text: str) -> bool:
    """Whether the END of the captured child output names a retryable
    device/transport failure (vs a genuine program error)."""
    tail = text[-CLASSIFY_TAIL_BYTES:]
    return any(p in tail for p in TRANSIENT_PATTERNS)


def is_retry_once_failure(text: str) -> bool:
    """Whether the END of the captured child output names a failure worth
    exactly one relaunch (see RETRY_ONCE_PATTERNS)."""
    tail = text[-CLASSIFY_TAIL_BYTES:]
    return any(p in tail for p in RETRY_ONCE_PATTERNS)


def probe_device(timeout_s: float = 180.0) -> bool:
    """Run a tiny matmul + host fetch in a fresh subprocess.

    A host fetch of the result is the completion criterion. Returns False
    on nonzero exit OR timeout (a wedged device can hang probes rather
    than refuse them)."""
    try:
        res = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            timeout=timeout_s,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return res.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(
    max_wait_s: float = 3600.0,
    interval_s: float = 60.0,
    probe_timeout_s: float = 180.0,
    probe_fn=None,
    echo=print,
    sleep_fn=time.sleep,
) -> bool:
    """Poll until the device answers, up to ``max_wait_s`` of waiting."""
    probe_fn = probe_fn or (lambda: probe_device(probe_timeout_s))
    deadline = time.monotonic() + max_wait_s
    attempt = 0
    while True:
        attempt += 1
        t0 = time.monotonic()
        if probe_fn():
            echo(f"{datetime.datetime.now()} device answering (attempt {attempt})")
            return True
        if time.monotonic() >= deadline:
            return False
        echo(
            f"{datetime.datetime.now()} device unresponsive "
            f"(attempt {attempt}); retrying in {interval_s:.0f}s"
        )
        # count time spent inside the hung probe toward the interval
        sleep_fn(max(0.0, interval_s - (time.monotonic() - t0)))


def run_supervised(
    argv,
    max_restarts: int = 10,
    max_wait_s: float = 3600.0,
    interval_s: float = 60.0,
    probe_timeout_s: float = 180.0,
    tail_bytes: int = 65536,
    hang_timeout_s: float | None = 3600.0,
    probe_fn=None,
    echo=print,
    sleep_fn=time.sleep,
    run_fn=None,
    poll_s: float = 5.0,
) -> int:
    """Run ``argv`` until it exits 0, restarting on transient device death.

    The child's stdout/stderr stream through to this process's stdout
    (line-buffered tee); the last ``tail_bytes`` are kept for failure
    classification. Non-transient failures return the child's exit code
    immediately. Returns 0 on success, the last exit code when restarts
    are exhausted or the device never comes back.

    ``hang_timeout_s``: a wedged device can HANG calls rather than fail
    them, so a child that produces no output for this long is killed and
    treated as a transient device failure — without this the
    supervisor's recovery loop would never engage on that failure shape.
    Size it above the longest legitimately silent phase (full-scale XLA
    compiles are minutes; the default 1 h is generous).
    ``None`` disables hang detection.

    ``probe_fn``/``run_fn``/``sleep_fn``/``poll_s`` exist for tests
    (inject fakes / shrink the liveness-poll granularity so hang-detection
    tests run in seconds); production callers use the defaults."""

    def default_run(argv):
        import os
        import threading

        # unbuffered child stdout: liveness is measured by bytes arriving
        # on this pipe, and a block-buffered child (Python's default when
        # piped) can hold sparse progress echoes in its 8 KiB stdio buffer
        # far past hang_timeout_s — a healthy run would be killed as wedged
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        proc = subprocess.Popen(
            list(argv), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env,
        )
        state = {"tail": b"", "last": time.monotonic()}
        lock = threading.Lock()

        def pump():
            assert proc.stdout is not None
            # read1 (not line iteration): ANY bytes count as liveness, so a
            # child whose only output is \r-updating progress bars is not
            # killed as hung while it waits for its first newline
            while True:
                chunk = proc.stdout.read1(65536)
                if not chunk:
                    break
                sys.stdout.buffer.write(chunk)
                sys.stdout.buffer.flush()
                with lock:
                    state["tail"] = (state["tail"] + chunk)[-tail_bytes:]
                    state["last"] = time.monotonic()

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        hung = False
        while True:
            try:
                proc.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            if hang_timeout_s is not None:
                with lock:
                    silent = time.monotonic() - state["last"]
                if silent >= hang_timeout_s:
                    hung = True
                    echo(
                        f"{datetime.datetime.now()} {HANG_MARKER} for "
                        f"{silent:.0f}s — killing it (assumed wedged device)"
                    )
                    proc.kill()
                    proc.wait()
                    break
        reader.join(timeout=10.0)
        tail = state["tail"].decode("utf-8", errors="replace")
        if hung:
            # classify as transient: the device probe gate decides when
            # it is safe to relaunch
            tail += f"\n{HANG_MARKER} (killed after {hang_timeout_s:.0f}s)\n"
        return proc.returncode, tail

    run_fn = run_fn or default_run
    restarts = 0
    retry_once_spent = False
    while True:
        echo(
            f"{datetime.datetime.now()} supervisor: launching "
            f"(restart {restarts}/{max_restarts}): {' '.join(map(str, argv))}"
        )
        code, tail = run_fn(argv)
        if code == 0:
            echo(f"{datetime.datetime.now()} supervisor: command succeeded")
            return 0
        if not is_transient_device_failure(tail):
            if (
                not retry_once_spent
                and restarts < max_restarts
                and is_retry_once_failure(tail)
            ):
                retry_once_spent = True
                echo(
                    f"{datetime.datetime.now()} supervisor: device memory "
                    f"exhausted (exit {code}) — retrying ONCE (restarts "
                    "can leave stale device-memory residue; a second "
                    "identical failure is treated as real)"
                )
            else:
                echo(
                    f"{datetime.datetime.now()} supervisor: non-transient "
                    f"failure (exit {code}) — not retrying"
                )
                return code
        if restarts >= max_restarts:
            echo(
                f"{datetime.datetime.now()} supervisor: transient failure but "
                f"restart budget exhausted ({max_restarts})"
            )
            return code
        restarts += 1
        echo(
            f"{datetime.datetime.now()} supervisor: transient device failure "
            f"(exit {code}); waiting for the device before restart "
            f"{restarts}/{max_restarts}"
        )
        if not wait_for_device(
            max_wait_s=max_wait_s,
            interval_s=interval_s,
            probe_timeout_s=probe_timeout_s,
            probe_fn=probe_fn,
            echo=echo,
            sleep_fn=sleep_fn,
        ):
            echo(
                f"{datetime.datetime.now()} supervisor: device did not return "
                f"within {max_wait_s:.0f}s — giving up"
            )
            return code


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m calamity_tpu.supervisor",
        description="Restart a resume-safe calibration command across "
        "transient device failures (see module docstring).",
    )
    ap.add_argument("--max_restarts", type=int, default=10)
    ap.add_argument("--max_wait", type=float, default=3600.0,
                    help="seconds to wait for the device to answer probes "
                         "after a transient failure")
    ap.add_argument("--probe_interval", type=float, default=60.0)
    ap.add_argument("--probe_timeout", type=float, default=180.0,
                    help="per-probe subprocess timeout (a wedged device "
                         "can hang probes rather than refuse them)")
    ap.add_argument("--hang_timeout", type=float, default=3600.0,
                    help="kill + retry the child if it prints nothing for "
                         "this many seconds (a wedged device can hang "
                         "calls); 0 disables")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to supervise (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (pass it after --)")
    return run_supervised(
        cmd,
        max_restarts=args.max_restarts,
        max_wait_s=args.max_wait,
        interval_s=args.probe_interval,
        probe_timeout_s=args.probe_timeout,
        hang_timeout_s=args.hang_timeout if args.hang_timeout > 0 else None,
    )


if __name__ == "__main__":
    sys.exit(main())
