"""The port's shared-memory regions (runtime/shm.py) against the JAX package's.

Ports of JAX tests/test_shm.py: a region written through the JAX package's
``SharedRegion`` is read by the port's and the reverse (the segment format
is one); bounds, keys, symlinks, negative shapes and bf16 behave alike; the
registry's verbs give the same answers; the facade's shared-memory verbs
and ModelInfer give JAX's JSON replies, over the socket too, and a
deadline turns a wedged verb into DEADLINE_EXCEEDED.
"""

import json
import os
import time
import uuid

import numpy as np
import pytest
import torch
import torch.nn as nn

from rs_face_detection_tpu.models import registry as jreg
from rs_face_detection_tpu.runtime import shm as jshm
from rs_face_detection_tpu.runtime.server import FacePipelineServicer as JServicer
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.runtime import shm as pshm
from rs_face_detection_tpu_torch.runtime.server import FacePipelineServicer as PServicer


def key():
    return f"rsfd_torch_test_{uuid.uuid4().hex[:12]}"


@pytest.mark.parametrize("writer, reader", [(jshm, pshm), (pshm, jshm)], ids=["jax->port", "port->jax"])
def test_a_region_is_read_by_the_other_package(writer, reader):
    k = key()
    with writer.SharedRegion.create(k, 1 << 16) as creator:
        arr = np.arange(1000, dtype=np.float32).reshape(10, 100)
        assert creator.write_array(arr, offset=128) == arr.nbytes
        attached = reader.SharedRegion.attach(k, 1 << 16)
        np.testing.assert_array_equal(attached.read_array("float32", (10, 100), offset=128), arr)
        attached.write_array(np.full((4,), 7, np.int64), offset=0)  # same pages, both ways
        np.testing.assert_array_equal(creator.read_array("int64", (4,), 0), np.full((4,), 7, np.int64))
        attached.close()
    assert not os.path.exists(f"/dev/shm/{k}")
    assert pshm.ALIGN == jshm.ALIGN and pshm.align_up(65) == jshm.align_up(65) == 128


def raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_bounds_keys_and_shapes_fail_alike():
    ka, kb = key(), key()
    with jshm.SharedRegion.create(ka, 256) as ra, pshm.SharedRegion.create(kb, 256) as rb:
        for action in (
            lambda r: r.write_array(np.zeros(1024, np.uint8), 0),
            lambda r: r.read_array("uint8", (16,), offset=250),
            lambda r: r.read_array("uint8", (16,), offset=-1),
            lambda r: r.read_array("float32", (-1,), 0),
            lambda r: r.read_array("float32", (4, -2), 0),
        ):
            ea, eb = raised(lambda: action(ra)), raised(lambda: action(rb))
            assert ea[0] == eb[0] and ea[1].replace(ka, kb) == eb[1]
        for bad in (lambda m: m.SharedRegion.create("../escape", 64), lambda m: m.SharedRegion.create("", 64),
                    lambda m: m.SharedRegion.create(key(), 0), lambda m: m.SharedRegion.attach(kb, 4096)):
            assert raised(lambda: bad(jshm)) == raised(lambda: bad(pshm))
    target, link = key(), key()
    with pshm.SharedRegion.create(target, 256):
        os.symlink(f"/dev/shm/{target}", f"/dev/shm/{link}")
        try:
            ja, pa = raised(lambda: jshm.SharedRegion.attach(link, 256)), raised(lambda: pshm.SharedRegion.attach(link, 256))
            assert ja == pa and "symlink" in pa[1]
        finally:
            os.unlink(f"/dev/shm/{link}")


def test_bfloat16_round_trip():
    import ml_dtypes

    bf16 = np.dtype(ml_dtypes.bfloat16)
    k = key()
    with pshm.SharedRegion.create(k, 4096) as region:
        arr = np.arange(64, dtype=np.float32).astype(bf16).reshape(8, 8)
        assert region.write_array(arr, offset=64) == 128
        np.testing.assert_array_equal(jshm.SharedRegion.attach(k, 4096).read_array(bf16, (8, 8), offset=64), arr)
        got = region.read_array(arr.dtype.name, (8, 8), offset=64)
        assert got.dtype == bf16 and np.array_equal(got, arr)
        # the port's torch tensors reach the same bytes
        t = torch.arange(64, dtype=torch.float32).to(torch.bfloat16).reshape(8, 8)
        np.testing.assert_array_equal(region.read_array("uint16", (8, 8), 64), t.view(torch.int16).numpy().view(np.uint16))


def test_registry_verbs_match():
    k = key()
    with pshm.SharedRegion.create(k, 512):
        regs = (jshm.SharedMemoryRegistry(), pshm.SharedMemoryRegistry())
        for reg in regs:
            reg.register("regionA", k, 512)
        steps = (
            lambda r: r.status(),
            lambda r: r.status("regionA"),
            lambda r: r.register("regionA", k, 512),
            lambda r: r.status("nope"),
            lambda r: r.get("nope"),
            lambda r: r.unregister("regionA"),
            lambda r: r.unregister("regionA"),
            lambda r: (r.register("r1", k, 512), r.register("r2", k, 256), sorted(r.unregister(None)), r.status()),
        )
        for step in steps:
            out = []
            for reg in regs:
                try:
                    out.append(("ok", step(reg)))
                except Exception as e:
                    out.append((type(e), str(e)))
            assert out[0] == out[1]
    for reg in regs:
        with pytest.raises(FileNotFoundError):
            reg.register("gone", k, 512)


class Doubler(nn.Module):
    def forward(self, x):
        return x * 2.0


class JDoubler:
    def apply(self, variables, x, train=False):
        return x * 2.0


def servicers():
    j, p = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    j.register_builder("doubler", lambda: (jreg.ModelSpec("doubler", (4,), "array"), JDoubler(), {}))
    p.register_builder("doubler", lambda: (preg.ModelSpec("doubler", (4,), "array"), Doubler()))
    return JServicer(None, j), PServicer(None, p)


def test_servicer_shm_verbs_and_infer_match():
    """The verb handlers, driven directly, give JAX's JSON replies."""
    k = key()
    with pshm.SharedRegion.create(k, 4096) as region:
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        body = {"name": "doubler", "input_shm": {"region": "r", "offset": 0, "dtype": "float32", "shape": [2, 4]},
                "output_shm": {"region": "r", "offset": 1024}}
        requests = [
            ("system_shared_memory_register", {"name": "r", "key": k, "byte_size": 4096}),
            ("system_shared_memory_status", {}),
            ("model_infer", body),
            ("model_infer", dict(body, input_shm=dict(body["input_shm"], region="nope"))),
            ("model_infer", dict(body, output_shm={"region": "r", "offset": 4090})),
            ("model_infer", dict(body, output_shm={"region": "nope", "offset": 0})),
            ("model_infer", dict(body, input_shm=dict(body["input_shm"], shape=[-1]))),
            ("system_shared_memory_unregister", {}),
            ("cuda_shared_memory_status", {}),
        ]
        replies = []
        for s in servicers():
            region.write_array(x, 0)
            sentinel = np.full((1,), 123.0, np.float32)
            region.write_array(sentinel, 4088)
            out = [json.loads(getattr(s, verb)(json.dumps(req).encode())) for verb, req in requests]
            (desc,) = out[2]["outputs_shm"]
            out.append(region.read_array(desc["dtype"], tuple(desc["shape"]), desc["offset"]).tolist())
            np.testing.assert_array_equal(region.read_array("float32", (1,), 4088), sentinel)  # not mutated
            replies.append(out)
        assert replies[1] == replies[0]
        assert replies[1][-1] == (x * 2.0).tolist()
    for s in servicers():
        assert "error" in json.loads(s.cuda_shared_memory_register(b"{}"))


def test_shm_model_infer_over_the_wire_and_deadline():
    grpc = pytest.importorskip("grpc")
    from rs_face_detection_tpu.runtime.server import FacePipelineClient
    from rs_face_detection_tpu_torch.runtime.server import serve

    class Slow(nn.Module):
        def forward(self, x):
            time.sleep(3.0)
            return x

    reg = preg.ModelRegistry("cpu")
    reg.register(preg.ModelSpec("doubler", (4,), "array"), Doubler())
    reg.register(preg.ModelSpec("slow", (1,), "array"), Slow())
    server = serve(None, reg, port=0)
    client = FacePipelineClient("localhost", server._rsfd_port, timeout_s=120)
    hasty = FacePipelineClient("localhost", server._rsfd_port, timeout_s=0.5)
    try:
        with pshm.SharedRegion.create(key(), 1 << 20) as region:
            client.register_region("zones", region)
            assert client.system_shared_memory_status()["regions"]["zones"]["byte_size"] == 1 << 20
            x = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
            (out,) = client.model_infer_shm("doubler", x, region)
            np.testing.assert_array_equal(out, 2.0 * x)
            np.testing.assert_array_equal(out, client.model_infer("doubler", x))
            client.system_shared_memory_unregister("zones")
            assert client.system_shared_memory_status()["regions"] == {}
        t0 = time.monotonic()
        with pytest.raises(grpc.RpcError) as err:
            hasty.model_infer("slow", np.zeros((1, 1), np.float32))
        assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED and time.monotonic() - t0 < 2.5
        assert hasty.server_live() is True
    finally:
        client.close()
        hasty.close()
        server.stop(0)
