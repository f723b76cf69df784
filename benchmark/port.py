"""The system under test: the port's FacePipeline on a configuration's weights.

The port's modules are built from its own classes, loaded with the shared
state_dicts (the ResNet-50 detector's 7x7 stem kernel in the port's
space-to-depth form), registered in a ``ModelRegistry`` and served to
``FacePipeline(registry=...)``, so that the registry's statistics count the
detector's and the heads' calls.
"""

from __future__ import annotations

from typing import Dict

import torch

from .weights import stem_to_s2d


def pipeline_config(cfg: dict):
    """The port's FacePipelineConfig for a configuration file."""
    from rs_face_detection_tpu_torch import configs as pc
    from rs_face_detection_tpu_torch.models.arcface import STAGES

    d, q, i = cfg["detector"], cfg["quality"], cfg["identification"]
    depth = next(name for name, layers in STAGES.items() if list(layers) == list(i["layers"]))
    sel, al = cfg["selection"], cfg["alignment"]
    return pc.FacePipelineConfig(
        detection=pc.FaceDetectionConfig(
            image_size=tuple(d["image_size"]), confidence_threshold=d["confidence_threshold"],
            iou_threshold=d["iou_threshold"], backbone=d["backbone"], max_candidates=d["max_candidates"],
            max_detections=d["max_detections"], feat_strides=tuple(d["feat_strides"]),
            pixel_means=tuple(d["pixel_means"]), pixel_stds=tuple(d["pixel_stds"]), pixel_scale=d["pixel_scale"]),
        quality=pc.FaceQualityConfig(image_size=tuple(q["image_size"]), threshold=q["threshold"],
                                     num_classes=q["num_classes"]),
        identification=pc.FaceIdentificationConfig(image_size=tuple(i["image_size"]),
                                                   embedding_dim=i["embedding_dim"], backbone=depth),
        selection=pc.FaceSelectionConfig(
            margin_center_left_ratio=sel["margin_center_left_ratio"],
            margin_center_right_ratio=sel["margin_center_right_ratio"],
            margin_edge_ratio=sel["margin_edge_ratio"], minimum_face_ratio=sel["minimum_face_ratio"]),
        alignment=pc.FaceAlignmentConfig(image_size=tuple(al["image_size"]),
                                         standard_landmarks=tuple(tuple(p) for p in al["template"])),
    )


def modules(cfg: dict, states: Dict[str, dict]):
    """The port's three networks with the shared weights, keyed by part."""
    from rs_face_detection_tpu_torch.models.arcface import IResNet
    from rs_face_detection_tpu_torch.models.classifiers import ResNet18Classifier
    from rs_face_detection_tpu_torch.models.retinaface import RetinaFace

    pcfg = pipeline_config(cfg)
    det_sd = dict(states["detector"])
    if cfg["detector"]["backbone"] == "resnet50":
        det_sd["body.conv1.weight"] = stem_to_s2d(det_sd["body.conv1.weight"])
    nets = {
        "detector": RetinaFace(cfg["detector"]["backbone"], cfg["detector"]["num_anchors"]),
        "quality": ResNet18Classifier(cfg["quality"]["num_classes"], softmax=True),
        "identification": IResNet(pcfg.identification.backbone, cfg["identification"]["embedding_dim"]),
    }
    for part, sd in (("detector", det_sd), ("quality", states["quality"]),
                     ("identification", states["identification"])):
        nets[part].load_state_dict(sd, strict=True)
    return pcfg, nets


def build(cfg: dict, states: Dict[str, dict], device: torch.device):
    """(FacePipeline, ModelRegistry) on ``device``."""
    from rs_face_detection_tpu_torch.models.registry import ModelRegistry, ModelSpec
    from rs_face_detection_tpu_torch.pipeline.face_pipeline import FacePipeline

    pcfg, nets = modules(cfg, states)
    registry = ModelRegistry(device)
    names = {"detector": pcfg.detection.model_name, "quality": pcfg.quality.model_name,
             "identification": pcfg.identification.model_name}
    for part, net in nets.items():
        w, h = cfg[part]["image_size"]
        registry.register(ModelSpec(names[part], (h, w, 3), part), net)
    return FacePipeline(pcfg, device=device, registry=registry), registry


def model_names(pipe) -> Dict[str, str]:
    c = pipe.config
    return {"detector": c.detection.model_name, "quality": c.quality.model_name,
            "identification": c.identification.model_name}

