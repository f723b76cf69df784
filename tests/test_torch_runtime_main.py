"""`python -m rs_face_detection_tpu_torch.runtime`, the port's serving entry point.

The port of tests/test_server.py::test_runtime_entrypoint_serves: on the
CPU (``--device cpu``) the process comes up, announces its port as JAX's
does (``serving on :<port>``) and answers the health verbs on the gRPC
facade, the Triton wire and the KServe-v2 REST endpoint (``--http-port
0``), to the port's clients and the JAX package's; SIGTERM stops it with
exit code 0.  Without ``--device`` it takes the card, so on a machine
without one it exits non-zero and says so, and serves nothing.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from deadlines import read_until

pytest.importorskip("grpc")

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _start(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "rs_face_detection_tpu_torch.runtime", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def test_runtime_entrypoint_serves_both_surfaces_on_the_cpu():
    from rs_face_detection_tpu.runtime.server import FacePipelineClient as JClient
    from rs_face_detection_tpu_torch.runtime.http import TritonHTTPClient
    from rs_face_detection_tpu_torch.runtime.server import FacePipelineClient
    from rs_face_detection_tpu_torch.runtime.wire import TritonWireClient

    proc = _start("--device", "cpu", "--port", "0", "--http-port", "0")
    try:
        lines, m = read_until(proc, r"serving on :(\d+)", 120)
        port = int(m.group(1))
        m = re.search(r"KServe-v2 HTTP endpoint on :(\d+)", "".join(lines))
        http_port = int(m.group(1)) if m else None
        assert port and http_port, f"server never announced its ports: {''.join(lines)}"
        assert "device cpu" in lines[-1]
        for client in (FacePipelineClient(port=port, timeout_s=60), JClient(port=port, timeout_s=60)):
            try:
                assert client.server_live() is True and client.server_ready() is True
            finally:
                client.close()
        wire = TritonWireClient(f"localhost:{port}", timeout_s=60)
        try:
            assert wire.server_live() and wire.server_ready()
        finally:
            wire.close()
        rest = TritonHTTPClient(port=http_port, timeout_s=60)
        assert rest.server_live() and rest.server_ready()
        assert rest.server_metadata()["name"] == "rs_face_detection_tpu_torch"
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    assert rc == 0, f"the server exited with {rc}"


def test_runtime_entrypoint_refuses_to_serve_without_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    proc = _start("--port", "0", "--http-port", "0")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in out and "pass --device cpu" in out, out
    assert "serving on" not in out
