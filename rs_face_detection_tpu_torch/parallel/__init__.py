"""Training on one device: the RetinaFace train step, its data loader and
train-state checkpoints (the JAX package's parallel/ without the mesh)."""

from .checkpoint import latest_step, restore_train_state, save_train_state
from .data import DetectionDataLoader, FaceExample, letterbox_host, parse_retinaface_label, wider_examples
from .train import TrainBatch, Trainer, TrainState, detection_loss, match_anchors

__all__ = [
    "latest_step",
    "restore_train_state",
    "save_train_state",
    "DetectionDataLoader",
    "FaceExample",
    "letterbox_host",
    "parse_retinaface_label",
    "wider_examples",
    "TrainBatch",
    "Trainer",
    "TrainState",
    "detection_loss",
    "match_anchors",
]
