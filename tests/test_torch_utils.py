"""The port's host utilities (utils/coordinate.py, utils/debug.py) against the JAX package's.

``Coord2D``/``Coord3D`` and ``image_to_rgb_array`` give equal values and
errors; ``named_landmarks_to_array`` the same (5, 2) rows.  Two debug
sessions, one per package, fed the same dumps write the same files, byte
for byte, apart from the time-stamped run directory a sink makes when
given none; while no sink is active a dump writes nothing.
"""

import os

import numpy as np
import pytest
import torch

from rs_face_detection_tpu import utils as jutils
from rs_face_detection_tpu.utils import debug as jdebug
from rs_face_detection_tpu_torch import utils
from rs_face_detection_tpu_torch.utils import debug


def test_coordinates_and_rgb_match_jax():
    assert utils.Coord2D(1.5, -2.0) == utils.Coord2D(1.5, -2.0)
    assert (utils.Coord2D(1.5, -2.0).x, utils.Coord3D(1, 2, 3).z) == (jutils.Coord2D(1.5, -2.0).x, jutils.Coord3D(1, 2, 3).z)
    with pytest.raises(AttributeError):
        utils.Coord3D(1, 2, 3).x = 0  # frozen, as JAX's
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    got = utils.image_to_rgb_array(img)
    np.testing.assert_array_equal(got, jutils.image_to_rgb_array(img))
    assert got.flags["C_CONTIGUOUS"] and not np.shares_memory(got, img)
    for bad in (img[..., :2], img[..., 0]):
        with pytest.raises(ValueError, match="expected"):
            utils.image_to_rgb_array(bad)
        with pytest.raises(ValueError, match="expected"):
            jutils.image_to_rgb_array(bad)
    marks = {"left_eye": (1, 2), "right_eye": (3, 4), "nose": (5, 6), "left_mouth": (7, 8), "right_mouth": (9, 10)}
    np.testing.assert_array_equal(utils.named_landmarks_to_array(marks), jutils.named_landmarks_to_array(marks))


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def _session(module, directory, arrays, image):
    sink = module.enable_debug(directory)
    try:
        assert module.sink() is sink
        for name, a in arrays.items():
            module.dump(name, a)
        module.dump_image("face", image)
        return sink.directory
    finally:
        module.disable_debug()


def test_debug_sink_writes_what_jax_writes(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    arrays = {"boxes": rng.normal(size=(3, 5)).astype(np.float32), "count": np.int64(3)}
    image = rng.integers(0, 256, (8, 6, 3)).astype(np.float32) * 1.1
    jdir = _session(jdebug, str(tmp_path / "jax"), arrays, image)
    pdir = _session(debug, str(tmp_path / "port"), arrays, image)
    assert _files(pdir) == _files(jdir)
    assert sorted(_files(pdir)) == ["000_boxes.npy", "001_count.npy", "002_face.png"]
    # CPU tensors, and the default time-stamped directory under the working directory
    monkeypatch.chdir(tmp_path)
    tdir = _session(debug, None, {k: torch.as_tensor(v) for k, v in arrays.items()}, torch.from_numpy(image))
    assert os.path.dirname(tdir) == ".rsfd_debug"
    assert _files(tdir) == _files(jdir)
    debug.dump("ignored", arrays["boxes"])  # no sink: nothing written
    debug.dump_image("ignored", image)
    assert sorted(_files(tdir)) == sorted(_files(jdir))
