"""Tests for the elastic run supervisor (calamity_tpu.supervisor)."""

import os
import sys
import textwrap

import pytest

from calamity_tpu import supervisor


def test_transient_classification():
    assert supervisor.is_transient_device_failure(
        "jax.errors.JaxRuntimeError: UNAVAILABLE: device worker process "
        "crashed or restarted."
    )
    assert supervisor.is_transient_device_failure(
        "grpc error: Socket closed while reading"
    )
    assert not supervisor.is_transient_device_failure(
        "ValueError: steps_per_execution bounds device-call length"
    )
    assert not supervisor.is_transient_device_failure(
        "Traceback (most recent call last): KeyError: 'antenna 7'"
    )


def test_run_supervised_restarts_until_success():
    """Two transient crashes, then success — supervisor retries through
    both, probing between attempts, and returns 0."""
    attempts = []
    probes = []

    def fake_run(argv):
        attempts.append(list(argv))
        if len(attempts) < 3:
            return 1, "UNAVAILABLE: device worker process crashed or restarted"
        return 0, "done"

    code = supervisor.run_supervised(
        ["cmd", "--flag"],
        max_restarts=5,
        run_fn=fake_run,
        probe_fn=lambda: probes.append(1) or True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
    )
    assert code == 0
    assert len(attempts) == 3
    assert all(a == ["cmd", "--flag"] for a in attempts)
    assert len(probes) == 2  # one wait_for_device round per restart


def test_resource_exhausted_retried_exactly_once():
    """A device-HBM ResourceExhausted is retried ONCE (worker restarts can
    leave stale HBM residue); a second identical failure surfaces as real."""
    oom = "jax.errors.JaxRuntimeError: RESOURCE_EXHAUSTED: device backend error"
    attempts = []

    def fail_twice(argv):
        attempts.append(1)
        return 1, oom

    code = supervisor.run_supervised(
        ["cmd"],
        max_restarts=5,
        run_fn=fail_twice,
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
    )
    assert code == 1
    assert len(attempts) == 2  # one retry, then the failure surfaces

    # a transient OOM (stale residue) recovers on the single retry
    attempts.clear()

    def fail_once(argv):
        attempts.append(1)
        return (0, "done") if len(attempts) > 1 else (1, oom)

    code = supervisor.run_supervised(
        ["cmd"],
        max_restarts=5,
        run_fn=fail_once,
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
    )
    assert code == 0
    assert len(attempts) == 2


def test_run_supervised_stops_on_real_failure():
    """A non-transient failure surfaces immediately — no retries."""
    attempts = []

    def fake_run(argv):
        attempts.append(1)
        return 2, "ValueError: no such polarization in the weights file"

    code = supervisor.run_supervised(
        ["cmd"], max_restarts=5, run_fn=fake_run,
        probe_fn=lambda: True, echo=lambda *_: None, sleep_fn=lambda *_: None,
    )
    assert code == 2
    assert len(attempts) == 1


def test_run_supervised_exhausts_budget():
    def fake_run(argv):
        return 1, "UNAVAILABLE: backend gone"

    code = supervisor.run_supervised(
        ["cmd"], max_restarts=2, run_fn=fake_run,
        probe_fn=lambda: True, echo=lambda *_: None, sleep_fn=lambda *_: None,
    )
    assert code == 1


def test_wait_for_device_gives_up(monkeypatch):
    """An always-dead device exhausts max_wait_s (monotonic time faked so
    the test is instant)."""
    t = [0.0]

    def fake_monotonic():
        t[0] += 30.0
        return t[0]

    monkeypatch.setattr(supervisor.time, "monotonic", fake_monotonic)
    ok = supervisor.wait_for_device(
        max_wait_s=120.0, interval_s=10.0, probe_fn=lambda: False,
        echo=lambda *_: None, sleep_fn=lambda *_: None,
    )
    assert not ok


def test_end_to_end_subprocess_resume(tmp_path):
    """Real child processes: the command crashes with a transient
    signature until its state file accumulates enough 'checkpoints',
    then succeeds — exercising the default run_fn (tee + tail capture)."""
    state = tmp_path / "state"
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        p = {str(state)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        if n + 1 < 3:
            print("step", n + 1)
            sys.stderr.write("UNAVAILABLE: device worker process crashed or restarted\\n")
            sys.exit(1)
        print("converged")
    """))
    code = supervisor.run_supervised(
        [sys.executable, "-S", str(script)],
        max_restarts=5,
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
    )
    assert code == 0
    assert state.read_text() == "3"


def test_classification_window_is_the_tail():
    """Recovered transport chatter EARLY in a long log must not make a
    later deterministic failure retryable; the same text at the end
    must."""
    early_noise = "W grpc StatusCode.UNAVAILABLE, retrying...\n"
    real_error = "Traceback...\nValueError: bad checkpoint structure\n"
    padding = "step log line\n" * 2000  # > CLASSIFY_TAIL_BYTES
    assert not supervisor.is_transient_device_failure(
        early_noise + padding + real_error
    )
    assert supervisor.is_transient_device_failure(
        padding + "UNAVAILABLE: device worker process crashed or restarted\n"
    )


def test_hang_detection_kills_and_retries():
    """A child that goes silent (wedged device call) is killed after
    hang_timeout_s and classified as transient; the relaunch succeeds."""
    import textwrap as tw
    import tempfile

    state = tempfile.mktemp()
    script = (
        "import os, sys, time\n"
        f"p = {state!r}\n"
        "first = not os.path.exists(p)\n"
        "open(p, 'w').write('x')\n"
        "if first:\n"
        "    print('starting', flush=True)\n"
        "    time.sleep(600)\n"  # wedged: no output, never exits
        "print('converged', flush=True)\n"
    )
    code = supervisor.run_supervised(
        [sys.executable, "-S", "-c", script],
        max_restarts=2,
        # generous vs interpreter startup: under a loaded host (full-scale
        # XLA compile in a sibling process) the RELAUNCHED child can take
        # seconds to print its first byte, and a tight timeout kills the
        # healthy relaunch as hung, exhausting restarts (observed flake)
        hang_timeout_s=4.0,
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
        poll_s=0.2,  # shrink the liveness poll so the test runs in seconds
    )
    assert code == 0
    os.unlink(state)


def test_carriage_return_output_counts_as_liveness():
    """A child whose only output is \\r-updating progress (tqdm-style,
    no newline until the end) must NOT be killed as hung: liveness counts
    raw bytes, not newline-terminated lines (review r3)."""
    script = (
        "import sys, time\n"
        "for i in range(8):\n"
        "    sys.stdout.write(f'\\rprogress {i}')\n"
        "    sys.stdout.flush()\n"
        "    time.sleep(0.4)\n"
        "print('\\nconverged', flush=True)\n"
    )
    code = supervisor.run_supervised(
        [sys.executable, "-S", "-c", script],
        max_restarts=0,  # any hang-kill would exhaust restarts -> nonzero
        hang_timeout_s=3.0,  # shorter than the ~3.2 s run, 7x the gaps
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
        poll_s=0.2,
    )
    assert code == 0


def test_unflushed_prints_count_as_liveness():
    """A child that prints WITHOUT flushing (calamity_tpu.utils.echo uses
    plain print) must not be killed as hung: a piped Python child is
    block-buffered by default, so sparse echoes would sit in its 8 KiB
    stdio buffer past hang_timeout_s — default_run launches the child
    with PYTHONUNBUFFERED=1 so bytes reach the liveness pipe immediately
    (review r3)."""
    script = (
        "import time\n"
        "for i in range(8):\n"
        "    print(f'echo {i}')\n"  # deliberately NOT flushed
        "    time.sleep(0.4)\n"
        "print('converged')\n"
    )
    code = supervisor.run_supervised(
        [sys.executable, "-S", "-c", script],
        max_restarts=0,  # any hang-kill would exhaust restarts -> nonzero
        hang_timeout_s=3.0,  # shorter than the ~3.2 s run, 7x the gaps
        probe_fn=lambda: True,
        echo=lambda *_: None,
        sleep_fn=lambda *_: None,
        poll_s=0.2,
    )
    assert code == 0


def test_cli_requires_command(capsys):
    with pytest.raises(SystemExit):
        supervisor.main(["--max_restarts", "1"])


def test_cli_passes_through(tmp_path):
    marker = tmp_path / "ran"
    code = supervisor.main(
        ["--max_restarts", "0", "--",
         sys.executable, "-S", "-c",
         f"open({str(marker)!r}, 'w').write('y')"]
    )
    assert code == 0
    assert marker.exists()
