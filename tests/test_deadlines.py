"""tests/deadlines.py: each helper returns what it waited for, and a stuck
wait fails within its deadline + 2 s, leaving no child alive.  The last
test holds the port's test files and these helpers to the rule: no wait
without a deadline.  The tests from before the port are not edited."""

import ast
import glob
import os
import subprocess
import sys
import threading
import time

import pytest

from deadlines import communicate_all, in_child, in_threads, join_all, read_until

HERE = os.path.dirname(os.path.abspath(__file__))
SLACK_S = 2.0


def child(src, **kw):
    return subprocess.Popen([sys.executable, "-c", src], stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


@pytest.mark.parametrize("stuck", [False, True])
def test_join_all(stuck):
    release = threading.Event()
    threads = [threading.Thread(target=release.wait, args=(60,), daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        if not stuck:
            release.set()
            join_all(threads, "waiting", 30.0)
            assert not any(t.is_alive() for t in threads)
            return
        t0 = time.monotonic()
        with pytest.raises(AssertionError, match="3 of 3 waiting threads did not finish within 1.0 s"):
            join_all(threads, "waiting", 1.0)
        assert time.monotonic() - t0 < 1.0 + SLACK_S
    finally:
        release.set()


@pytest.mark.parametrize("case", ["results", "raises", "stuck"])
def test_in_threads(case):
    release = threading.Event()

    def call(i):
        if case == "raises" and i == 2:
            raise ValueError("client 2")
        if case == "stuck" and i == 1:
            release.wait(60)
        return i * i

    t0 = time.monotonic()
    try:
        if case == "results":
            assert in_threads(call, 4, "calling", 30.0) == [0, 1, 4, 9]
        else:
            message = "client 2" if case == "raises" else "1 of 4 calling threads did not finish within 1.0 s"
            with pytest.raises((ValueError, AssertionError), match=message):
                in_threads(call, 4, "calling", 1.0 if case == "stuck" else 30.0)
        assert time.monotonic() - t0 < 1.0 + SLACK_S
    finally:
        release.set()


def running(pid):
    """Whether ``pid`` is a process that has not exited (a zombie has)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except FileNotFoundError:
        return False


def square_or_hang(x, pid_file, hangs):
    """x * x in the child in_child starts, after its pid is appended to
    ``pid_file``; the first ``hangs`` launches sleep instead."""
    with open(pid_file, "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(pid_file) as f:
        if len(f.read().split()) <= hangs:
            time.sleep(60)
    return x * x


def jax_settings():
    import jax

    return jax.config.jax_platforms, jax.config.jax_compilation_cache_dir


def test_in_child_takes_the_suites_jax_settings():
    import jax

    assert in_child(jax_settings, timeout_s=60.0) == jax_settings()
    assert jax.config.jax_compilation_cache_dir  # conftest set one


@pytest.mark.parametrize("hangs", [0, 1, 2], ids=["returns", "hangs once", "hangs twice"])
def test_in_child(hangs, tmp_path):
    pid_file = tmp_path / "child.pids"
    t0 = time.monotonic()
    if hangs < 2:  # a module that costs nothing to import, in place of conftest's JAX
        assert in_child(square_or_hang, 7, str(pid_file), hangs, timeout_s=3.0, setup="os") == 49
    else:
        with pytest.raises(AssertionError, match="square_or_hang did not finish within 3.0 s, in two launches"):
            in_child(square_or_hang, 7, str(pid_file), hangs, timeout_s=3.0, setup="os")
    assert time.monotonic() - t0 < 3.0 * min(hangs + 1, 2) + SLACK_S
    pids = [int(p) for p in pid_file.read_text().split()]
    assert len(pids) == min(hangs + 1, 2), "launched once more only after a timeout"
    assert not any(running(p) for p in pids), "a child outlived its deadline"


READ_CASES = {
    "silent": ("import time; time.sleep(60)", 1.0, "no line matched"),
    "exits first": ("print('one'); print('two')", 30.0, "the output ended before a line matched"),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_read_until_fails(case):
    src, timeout_s, message = READ_CASES[case]
    proc = child(src)
    try:
        t0 = time.monotonic()
        with pytest.raises(AssertionError, match=message) as err:
            read_until(proc, r"serving on :(\d+)", timeout_s)
        assert time.monotonic() - t0 < timeout_s + SLACK_S
        if case == "exits first":
            assert "one\ntwo\n" in str(err.value)
    finally:
        proc.kill()
        proc.wait(timeout=10)


@pytest.mark.parametrize("match", [r"serving on :(\d+)", lambda line: line.startswith("serving")], ids=["regex", "predicate"])
def test_read_until_returns_the_lines_at_the_match(match):
    proc = child("import time; print('starting', flush=True); print('serving on :4321', flush=True); time.sleep(60)")
    try:
        lines, hit = read_until(proc, match, 30.0)
        assert lines == ["starting\n", "serving on :4321\n"]
        assert (hit is True) if callable(match) else (hit.group(1) == "4321")
    finally:
        proc.kill()
        proc.wait(timeout=10)


SLEEP = "import time; time.sleep(60)"


@pytest.mark.parametrize("case", ["all finish", "one sleeps", "one fails", "a session's grandchild"])
def test_communicate_all(case, tmp_path):
    if case == "all finish":
        procs = [child("print('out 0')"), child("import sys; print('out 1'); print('err 1', file=sys.stderr)")]
        assert communicate_all(procs, 30.0) == [(0, "out 0\n", ""), (0, "out 1\n", "err 1\n")]
        return
    if case == "one sleeps":
        procs = [child("print('still here', flush=True); " + SLEEP), child("pass")]
        t0 = time.monotonic()
        with pytest.raises(AssertionError, match="rank 0 of 2 passed its 1.0 s deadline:\nstill here"):
            communicate_all(procs, 1.0)
        assert time.monotonic() - t0 < 1.0 + SLACK_S
    elif case == "one fails":
        procs = [child(SLEEP), child("raise SystemExit(3)")]
        t0 = time.monotonic()
        (rc0, _, _), (rc1, _, _) = communicate_all(procs, 30.0)
        assert time.monotonic() - t0 < SLACK_S + 1.0  # not held to the deadline
        assert (rc0, rc1) == (-9, 3)
    else:
        pid_file = tmp_path / "grandchild.pid"
        spawn = (f"import subprocess, sys, time; g = subprocess.Popen([sys.executable, '-c', {SLEEP!r}]); "
                 f"open({str(pid_file)!r}, 'w').write(str(g.pid)); time.sleep(60)")
        procs = [child(spawn, start_new_session=True)]
        t0 = time.monotonic()
        with pytest.raises(AssertionError, match="torchrun 0 of 1 passed its 2.0 s deadline"):
            communicate_all(procs, 2.0, what="torchrun")
        assert time.monotonic() - t0 < 2.0 + SLACK_S
        grandchild = int(pid_file.read_text())
        assert not running(grandchild), "the grandchild outlived its process group's kill"
    assert all(p.poll() is not None for p in procs)


def _unbounded(call):
    """Why ``call`` waits with no deadline, or None."""
    f, kws = call.func, {k.arg for k in call.keywords}
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    bare = not call.args and not call.keywords
    if isinstance(f, ast.Attribute) and bare and name in ("join", "wait", "result", "exception", "get", "acquire"):
        return f".{name}() with no timeout"
    if name == "FacePipelineClient" and "timeout_s" not in kws and len(call.args) < 3:
        return "FacePipelineClient without timeout_s"
    if (isinstance(f, ast.Attribute) and getattr(f.value, "id", None) == "subprocess"
            and name in ("run", "call", "check_call", "check_output") and "timeout" not in kws):
        return f"subprocess.{name} without timeout"
    if name == "communicate" and "timeout" not in kws:
        return ".communicate() without timeout"
    if name == "readline":
        return "readline() on the test's own thread"
    return None


def test_every_wait_in_the_tests_has_a_deadline():
    found = []
    mine = ("test_torch_*.py", "test_deadlines.py", "deadlines.py", "torch_mirrors.py")
    for path in sorted(p for pattern in mine for p in glob.glob(os.path.join(HERE, pattern))):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            why = isinstance(node, ast.Call) and _unbounded(node)
            if why:
                found.append(f"{os.path.basename(path)}:{node.lineno}: {why}")
    assert not found, "waits with no deadline:\n" + "\n".join(found)
