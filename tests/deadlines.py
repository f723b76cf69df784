"""Deadlines for the tests' waits.

Every wait in a port test (and in these helpers) goes through this module or
passes a ``timeout``, so that a stuck thread, child or server fails its own
test, not the whole run; ``tests/test_deadlines.py`` checks it.
"""

import importlib
import multiprocessing
import os
import queue
import re
import signal
import subprocess
import threading
import time

#: Deadline of a test's RPCs, streams and client threads.
RPC_S = 120.0


def join_all(threads, what, timeout_s=RPC_S):
    """Join the threads within one deadline; fail naming how many are alive."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    stuck = sum(t.is_alive() for t in threads)
    assert not stuck, f"{stuck} of {len(threads)} {what} threads did not finish within {timeout_s} s"


def in_threads(fn, n, what, timeout_s=RPC_S):
    """``[fn(0), ..., fn(n - 1)]``, each called on a daemon thread of its own,
    all released at once and joined within one deadline.  The first
    exception a call raised (``pytest.fail`` and ``SystemExit`` too) is
    raised here."""
    outs, errors, start = [None] * n, [], threading.Barrier(n)

    def one(i):
        try:
            start.wait(timeout=timeout_s)
            outs[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    join_all(threads, what, timeout_s)
    if errors:
        raise errors[0]
    return outs


def in_child(fn, *args, timeout_s=RPC_S, setup="conftest"):
    """``fn(*args)`` in a fresh process, for a call of the JAX reference that
    can wedge its whole process (JAX's Pallas TPU interpret mode can deadlock
    two threads' dispatch).  ``fn`` is a module-level function.  The child
    imports ``setup`` first: the suite's ``conftest``, so that the call runs
    under the same JAX settings as its test.  A child that passes the
    deadline is ended and the call launched once more, since the hang is in
    JAX and not in the code under test; a second one fails.  Never use it
    for the code under test."""
    for _ in range(2):
        with multiprocessing.get_context("spawn").Pool(1, importlib.import_module, (setup,)) as pool:
            try:
                return pool.apply_async(fn, args).get(timeout=timeout_s)
            except multiprocessing.TimeoutError:
                pass
    raise AssertionError(f"{fn.__name__} did not finish within {timeout_s} s, in two launches")


def _pump(stream, sink):
    for line in iter(stream.readline, ""):
        sink.put(line)
    sink.put("")


def read_until(proc, match, timeout_s):
    """``(lines, hit)``: the child's stdout lines up to the first that
    ``match`` (a regex, or a predicate of the line) hits, and the hit.

    A daemon thread reads the lines, and drains the pipe afterwards, so the
    deadline holds while the child prints nothing.  Fails showing the lines
    if the deadline passes or the output ends first.  Once per child.
    """
    test = match if callable(match) else re.compile(match).search
    lines, pending, deadline = [], queue.Queue(), time.monotonic() + timeout_s
    threading.Thread(target=_pump, args=(proc.stdout, pending), daemon=True).start()
    while True:
        try:
            line = pending.get(timeout=max(deadline - time.monotonic(), 0.0))
        except queue.Empty:
            raise AssertionError(f"no line matched {match!r} within {timeout_s} s:\n{''.join(lines)}") from None
        assert line, f"the output ended before a line matched {match!r}:\n{''.join(lines)}"
        lines.append(line)
        hit = test(line)
        if hit:
            return lines, hit


def _kill(proc):
    """SIGKILL the child, or its process group where it leads one
    (``start_new_session=True``), so that no grandchild outlives the test."""
    try:
        if os.getpgid(proc.pid) == proc.pid:
            os.killpg(proc.pid, signal.SIGKILL)
        else:
            proc.kill()
    except ProcessLookupError:
        pass


def communicate_all(procs, timeout_s, what="rank"):
    """``[(returncode, stdout, stderr), ...]`` of the children, drained in
    turn under one deadline.

    They are taken as ranks of one job: once one exits non-zero the rest are
    killed (returncode -9), as they would only wait on it.  At the deadline
    every child still running is killed, and the call fails naming the first
    with the tail of its output.
    """
    results, deadline = [None] * len(procs), time.monotonic() + timeout_s
    while None in results:
        late = time.monotonic() >= deadline
        if late or any(r and r[0] for r in results):
            waiting = [i for i, r in enumerate(results) if r is None]
            for i in waiting:
                _kill(procs[i])
            for i in waiting:
                try:
                    out, err = procs[i].communicate(timeout=10)
                except subprocess.TimeoutExpired:  # a grandchild holds the pipe
                    out, err = "", ""
                results[i] = (procs[i].poll(), out, err)
            if late:
                tail = "\n".join(s[-4000:] for s in results[waiting[0]][1:] if s)
                raise AssertionError(f"{what} {waiting[0]} of {len(procs)} passed its {timeout_s} s deadline:\n{tail}")
            break
        for i, p in enumerate(procs):
            if results[i] is None:
                try:
                    out, err = p.communicate(timeout=0.05)
                except subprocess.TimeoutExpired:
                    continue
                results[i] = (p.returncode, out, err)
    return results
