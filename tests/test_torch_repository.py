"""The port's model repository (runtime/repository.py) against the JAX package's.

  - ``parse_pbtxt`` gives equal dicts on the configs of JAX
    tests/test_repository.py and raises the same exception, with the same
    message, on the malformed ones;
  - ``scan_repository`` gives equal entries and the same per-model errors on
    one tree holding every case of that file (versions, a name mismatch, a
    duplicate singular field, weightless and non-model entries, a malformed
    config, a malformed ensemble);
  - a repository written by JAX's ``write_repository_entry`` serves from the
    port unchanged, and one the port's writer wrote serves from JAX:
    outputs within 1e-5 (the ResNet-18 probabilities' tolerance of
    tests/test_torch_models.py), the same ModelSpec, the same flax paths;
  - an ensemble of the repository gives the same outputs and ModelConfig
    from both servers, a broken model is registered UNAVAILABLE in both,
    and an ensemble naming an unknown member fails at load in both.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from rs_face_detection_tpu.models import registry as jreg
from rs_face_detection_tpu.models.checkpoint_io import save_imported as j_save_imported
from rs_face_detection_tpu.models.classifiers import init_resnet18_classifier
from rs_face_detection_tpu.runtime import repository as jrepo
from rs_face_detection_tpu_torch.models import registry as preg
from rs_face_detection_tpu_torch.models.checkpoint_io import load_imported_model
from rs_face_detection_tpu_torch.runtime import repository as prepo

torch.set_num_threads(2)

META = {"family": "resnet18", "num_outputs": 3, "image_size": [32, 32], "softmax": True}
TOL = 1e-5

CONFIGS = [
    """
# generated
name: "face_detection_retina"
platform: "tensorrt_plan"
max_batch_size: 0
input [
  {
    name: "data"
    data_type: TYPE_FP32
    format: FORMAT_NCHW
    dims: [ 1, 3, 640, 640 ]
  }
]
output [
  { name: "face_rpn_cls_prob_reshape_stride32" data_type: TYPE_FP32 dims: [1, 4, 20, 20] },
  { name: "face_rpn_bbox_pred_stride32" data_type: TYPE_FP32 dims: [1, 8, 20, 20] }
]
dynamic_batching {
  preferred_batch_size: [ 4, 8 ]
  max_queue_delay_microseconds: 100
}
instance_group [ { count: 2 kind: KIND_GPU } ]
""",
    'input { name: "a" }\ninput { name: "b" }\nflag: true;\nneg: -1\nratio: 0.25\njoined: "ab" "cd"\nsingle: \'sq\'\n',
    'note: "café \\"x\\" \\n tab\\t"',
    'name: "ens"\nplatform: "ensemble"\nensemble_scheduling { step [ { model_name: "a" model_version: -1 '
    'input_map { key: "data" value: "IMAGE" } output_map { key: "output" value: "OUT" } } ] }',
]
MALFORMED = ["input {", "input }", 'name: "x', "dims: [1, 2", ": 3", "a: {", "}", "@"]


@pytest.mark.parametrize("text", CONFIGS)
def test_parse_pbtxt_matches_jax(text):
    assert prepo.parse_pbtxt(text) == jrepo.parse_pbtxt(text)


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_configs_raise_alike(text):
    with pytest.raises(Exception) as want:
        jrepo.parse_pbtxt(text)
    with pytest.raises(type(want.value), match=None) as got:
        prepo.parse_pbtxt(text)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A JAX-written resnet18-family checkpoint, its JAX model and variables,
    and the port's module loaded from the file."""
    model, variables = init_resnet18_classifier(3, (32, 32), softmax=True)
    variables = jax.tree.map(np.asarray, variables)
    path = str(tmp_path_factory.mktemp("ckpt") / "m.npz")
    j_save_imported(path, variables, META)
    return model, variables, load_imported_model(path)


def write_tree(root, variables):
    """Every case of JAX's scan tests, in one tree."""
    jrepo.write_repository_entry(root, "good", variables, META, version=1)
    jrepo.write_repository_entry(root, "good", variables, META, version=3)
    os.makedirs(os.path.join(root, "good", "7"))
    for name, text in (("mismatch", 'name: "other"\n'), ("dup", 'name: "dup"\nmax_batch_size: 4\nmax_batch_size: 8\n'),
                       ("weightless", 'name: "weightless"\n'), ("broken", 'name: "broken"\ninput {'),
                       ("badens", 'name: "badens"\nplatform: "ensemble"\n')):
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, "config.pbtxt"), "w") as f:
            f.write(text)
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("hi")


def test_scan_matches_jax(tmp_path, tiny):
    root = str(tmp_path)
    write_tree(root, tiny[1])
    jerr, perr = [], []
    want = [dataclasses.asdict(m) for m in jrepo.scan_repository(root, errors=jerr)]
    got = [dataclasses.asdict(m) for m in prepo.scan_repository(root, errors=perr)]
    assert got == want and [m["name"] for m in got] == ["good"] and got[0]["version"] == 3
    assert perr == jerr and [n for n, _ in perr] == ["badens", "broken", "dup", "mismatch"]
    for bad in ("/nonexistent/repo/path", root):
        with pytest.raises(ValueError) as w:
            jrepo.scan_repository(bad)
        with pytest.raises(ValueError) as g:
            prepo.scan_repository(bad)
        assert str(g.value) == str(w.value)
    jr, pr = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    assert prepo.attach_repository_builders(pr, root) == jrepo.attach_repository_builders(jr, root)
    assert pr.index() == jr.index()
    pr.load("good")
    for name in ("broken", "dup"):
        with pytest.raises(ValueError) as w:
            jr.load(name)
        with pytest.raises(ValueError) as g:
            pr.load(name)
        assert str(g.value) == str(w.value)


def spec_fields(spec):
    return dataclasses.asdict(spec)


def test_jax_written_repository_serves_from_the_port(tmp_path, tiny):
    model, variables, _ = tiny
    root = str(tmp_path)
    jrepo.write_repository_entry(root, "face_quality", variables, META, max_batch_size=4)
    with open(os.path.join(root, "face_quality", "config.pbtxt"), "a") as f:
        f.write("dynamic_batching { max_queue_delay_microseconds: 2000 }\n")
    jr, pr = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    jrepo.attach_repository_builders(jr, root)
    prepo.attach_repository_builders(pr, root)
    assert spec_fields(pr.spec("face_quality")) == spec_fields(jr.spec("face_quality"))
    x = np.random.default_rng(0).random((2, 32, 32, 3), np.float32)
    want = np.asarray(model.apply(variables, x))
    got = pr.infer("face_quality", x.transpose(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_port_written_repository_serves_from_jax(tmp_path, tiny):
    model, variables, port = tiny
    jroot, proot = str(tmp_path / "j"), str(tmp_path / "p")
    jpath = jrepo.write_repository_entry(jroot, "face_quality", variables, META, version=2)
    ppath = prepo.write_repository_entry(proot, "face_quality", port, META, version=2)
    assert os.path.relpath(ppath, proot) == os.path.relpath(jpath, jroot)
    jcfg = open(os.path.join(jroot, "face_quality", "config.pbtxt")).read()
    pcfg = open(os.path.join(proot, "face_quality", "config.pbtxt")).read()
    assert pcfg == jcfg.replace('backend: "rs_face_detection_tpu"', 'backend: "rs_face_detection_tpu_torch"')
    with np.load(jpath) as j, np.load(ppath) as p:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(p[k], j[k])
    jr = jreg.ModelRegistry()
    jrepo.attach_repository_builders(jr, proot)
    x = np.random.default_rng(1).random((1, 32, 32, 3), np.float32)
    np.testing.assert_allclose(np.asarray(jr.infer("face_quality", x)), np.asarray(model.apply(variables, x)),
                               rtol=0, atol=TOL)
    # a newer version goes into the same entry and leaves the config alone
    prepo.write_repository_entry(proot, "face_quality", port, META, version=3, max_batch_size=8)
    assert open(os.path.join(proot, "face_quality", "config.pbtxt")).read() == pcfg
    assert prepo.scan_repository(proot)[0].version == 3


ENSEMBLE = (
    'name: "ens"\nplatform: "ensemble"\nmax_batch_size: 0\n'
    'input [ { name: "IMAGE" data_type: TYPE_FP32 dims: [1, 3, 32, 32] } ]\n'
    'output [ { name: "PROBS" data_type: TYPE_FP32 dims: [1, 3] } ]\n'
    'ensemble_scheduling { step [ { model_name: "%s" model_version: -1 '
    'input_map { key: "data" value: "IMAGE" } output_map { key: "output" value: "PROBS" } } ] }\n'
)


def test_repository_ensemble_matches_jax(tmp_path, tiny):
    grpc = pytest.importorskip("grpc")
    from rs_face_detection_tpu.runtime.server import serve as jserve
    from rs_face_detection_tpu.runtime.wire import TritonWireClient
    from rs_face_detection_tpu_torch.runtime.server import serve as pserve

    root = str(tmp_path)
    jrepo.write_repository_entry(root, "face_quality", tiny[1], META)
    for name, member in (("ens", "face_quality"), ("ens_unknown", "absent")):
        os.makedirs(os.path.join(root, name, "1"))
        with open(os.path.join(root, name, "config.pbtxt"), "w") as f:
            f.write((ENSEMBLE % member).replace('"ens"', f'"{name}"'))
    jr, pr = jreg.ModelRegistry(), preg.ModelRegistry("cpu")
    jrepo.attach_repository_builders(jr, root)
    prepo.attach_repository_builders(pr, root)
    js, ps = jserve(None, jr, port=0), pserve(None, pr, port=0)
    jc, pc = (TritonWireClient(f"localhost:{s._rsfd_port}", timeout_s=60) for s in (js, ps))
    try:
        for c in (jc, pc):
            c.repository_model_load("ens")
        assert pr.memory_usage_bytes("ens") == 0
        assert pc.model_config("ens") == jc.model_config("ens")
        x = np.random.default_rng(2).random((1, 3, 32, 32), np.float32)
        ((jn, js_, jo),), ((pn, ps_, po),) = (c.model_infer("ens", x, input_name="IMAGE") for c in (jc, pc))
        assert (pn, ps_) == (jn, js_) == ("PROBS", [1, 3])
        np.testing.assert_allclose(po, jo, rtol=0, atol=TOL)
        for c in (jc, pc):
            with pytest.raises(grpc.RpcError) as e:
                c.repository_model_load("ens_unknown")
            assert e.value.code() == grpc.StatusCode.INTERNAL and "absent" in e.value.details()
    finally:
        jc.close()
        pc.close()
        js.stop(0)
        ps.stop(0)
