"""Train-to-detect on the port: the loop of tests/test_train_to_detect.py.

The port's Trainer trains the 64x64 RetinaFace on synthetic "faces" (bright
squares with dark eye dots and a fixed landmark pattern, utils/synthetic.py)
for 250 steps on the CPU, then the trained weights detect held-out scenes
through the port's RetinaFaceDetection and the AP harness, with JAX's
thresholds: final loss < first / 5, AP > 0.2, recall > 0.25, and random
weights under half the AP.  The checkpoint the port writes
(models/weights.py::save_flax_checkpoint) then serves from the JAX
package's RetinaFaceDetection, whose detections agree with the port's
within 1e-3 px.
"""

import numpy as np
import torch

from rs_face_detection_tpu.configs import FaceDetectionConfig as JaxDetectionConfig
from rs_face_detection_tpu.models.registry import load_variables
from rs_face_detection_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from rs_face_detection_tpu.pipeline.detection import RetinaFaceDetection as JaxRetinaFaceDetection
from rs_face_detection_tpu_torch.configs import FaceDetectionConfig
from rs_face_detection_tpu_torch.models.weights import save_flax_checkpoint, seeded_state
from rs_face_detection_tpu_torch.ops.eval import evaluate_detector
from rs_face_detection_tpu_torch.parallel.train import TrainBatch, Trainer
from rs_face_detection_tpu_torch.pipeline.detection import RetinaFaceDetection
from rs_face_detection_tpu_torch.utils.synthetic import synth_batch_arrays

torch.set_num_threads(2)

EVAL = dict(image_size=(64, 64), confidence_threshold=0.3, max_candidates=64, max_detections=8)


def _detector(trainer, state_dict):
    model = trainer.new_model()
    model.load_state_dict(state_dict)
    return RetinaFaceDetection(FaceDetectionConfig(**EVAL), model=model, device="cpu")


def test_training_learns_to_detect(tmp_path):
    train_cfg = FaceDetectionConfig(image_size=(64, 64), confidence_threshold=0.5, max_candidates=64,
                                    max_detections=8)
    trainer = Trainer(train_cfg, learning_rate=2e-3, device="cpu")
    state = trainer.init_state(seed=0)
    step = trainer.make_train_step()
    rng = np.random.default_rng(0)
    first_loss = None
    for _ in range(250):
        state, metrics = step(state, TrainBatch(*synth_batch_arrays(rng, 8)))
        if first_loss is None:
            first_loss = float(metrics["loss"])
    final_loss = float(metrics["loss"])
    assert final_loss < first_loss / 5, (first_loss, final_loss)

    dataset = []
    for _ in range(12):
        imgs, boxes, _, valid = synth_batch_arrays(rng, 1)
        dataset.append((np.clip(imgs[0], 0, 255).astype(np.uint8), boxes[0][valid[0]]))
    trained = state.export_state_dict()
    det = _detector(trainer, trained)
    res = evaluate_detector(det, dataset, iou_threshold=0.5)
    assert res["ap"] > 0.2, res
    assert res["recall"] > 0.25, res

    rand_model = trainer.new_model()
    res_rand = evaluate_detector(_detector(trainer, seeded_state(rand_model, 3)), dataset, iou_threshold=0.5)
    assert res_rand["ap"] < res["ap"] / 2, (res_rand, res)

    # The registry checkpoint serves from the JAX package's detector.
    path = str(tmp_path / "face_detection_retina.npz")
    save_flax_checkpoint(path, trainer.family, trained)
    jax_det = JaxRetinaFaceDetection(JaxDetectionConfig(**EVAL), model=JaxRetinaFace(backbone="mobilenet025"),
                                     variables=load_variables(path))
    found = 0
    for img, _ in dataset:
        (d, k), (jd, jk) = det(img), jax_det(img)
        jd, jk = np.asarray(jd), np.asarray(jk)
        assert d.shape == jd.shape, (d.shape, jd.shape)
        if len(d):
            assert np.abs(d[:, :4] - jd[:, :4]).max() <= 1e-3 and np.abs(k - jk).max() <= 1e-3
            assert np.abs(d[:, 4] - jd[:, 4]).max() <= 1e-5
        found += len(d)
    assert found >= len(dataset)
