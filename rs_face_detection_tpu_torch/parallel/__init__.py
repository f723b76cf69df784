"""Parallelism: process groups and device meshes, sharded training (FSDP over
a ("data", "model") mesh, with global BatchNorm statistics), its data
loader and sharded train-state checkpoints, the tensor-parallel ViT, and
data-parallel serving over replicas of the detector."""

from ..serving.detection_server import DetectionServer
from .checkpoint import latest_step, restore_train_state, save_train_state
from .data import DetectionDataLoader, FaceExample, letterbox_host, parse_retinaface_label, wider_examples
from .mesh import (
    data_sharding,
    fsdp_param_spec,
    initialize_distributed,
    make_mesh,
    pytree_shardings,
    replicated,
    shard_pytree_fsdp,
)
from .tp import make_tp_vit_fn, vit_tp_param_spec, vit_tp_shardings
from .train import TrainBatch, Trainer, TrainState, detection_loss, match_anchors

__all__ = [
    "data_sharding",
    "initialize_distributed",
    "latest_step",
    "restore_train_state",
    "save_train_state",
    "fsdp_param_spec",
    "make_mesh",
    "pytree_shardings",
    "replicated",
    "shard_pytree_fsdp",
    "DetectionServer",
    "letterbox_host",
    "make_tp_vit_fn",
    "vit_tp_param_spec",
    "vit_tp_shardings",
    "DetectionDataLoader",
    "FaceExample",
    "parse_retinaface_label",
    "wider_examples",
    "TrainBatch",
    "Trainer",
    "TrainState",
    "detection_loss",
    "match_anchors",
]
