"""SmallCNN -- a compact classifier used as a TEST DOUBLE.

Counterpart of rs_face_detection_tpu/models/heads.py.  The production
heads are the real architectures (the ResNet-18 classifier, MiniFASNet);
SmallCNN stands in for them in pipeline-mechanics tests, where a strided
conv trunk and a global average pool run in milliseconds at any size, and
for custom registry injection.  Each conv is conv (no bias, padding k//2) +
BatchNorm + ReLU; input (B, 3, H, W) normalized, output (B, num_outputs)
probabilities (``softmax``) or logits.

Module names follow the flax ones (``stem``, ``c{i}a``, ``c{i}b``, ``fc``),
so ``small_cnn_map`` is a renaming for the weight bridge
(models/weights.py::state_dict_from_jax).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import conv_bn


class SmallCNN(nn.Module):
    """Strided conv trunk + GAP + dense head."""

    def __init__(
        self, num_outputs: int, widths: Sequence[int] = (32, 64, 128, 256), softmax: bool = True
    ) -> None:
        super().__init__()
        self.widths, self.softmax = tuple(widths), softmax
        self.stem = conv_bn(3, self.widths[0], 3, 2)
        inp = self.widths[0]
        for i, w in enumerate(self.widths[1:]):
            setattr(self, f"c{i}a", conv_bn(inp, w, 3, 2))
            setattr(self, f"c{i}b", conv_bn(w, w, 3, 1))
            inp = w
        self.fc = nn.Linear(inp, num_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.float())
        for i in range(len(self.widths) - 1):
            x = getattr(self, f"c{i}b")(getattr(self, f"c{i}a")(x))
        x = self.fc(x.mean(dim=(2, 3)))
        return torch.softmax(x, dim=-1) if self.softmax else x


def small_cnn_map(widths: Sequence[int] = (32, 64, 128, 256)) -> Dict[str, Tuple]:
    """{flax path: (torch key, kind)} of a SmallCNN of these widths."""
    m: Dict[str, Tuple] = {}

    def conv_bn_entry(name: str) -> None:
        m[f"params/{name}/Conv_0/kernel"] = (f"{name}.0", "conv")
        m[f"params/{name}/BatchNorm_0"] = (f"{name}.1", "bn")

    conv_bn_entry("stem")
    for i in range(len(widths) - 1):
        conv_bn_entry(f"c{i}a")
        conv_bn_entry(f"c{i}b")
    m["params/fc"] = ("fc", "dense")
    return m


def init_small_cnn(
    num_outputs: int,
    softmax: bool = True,
    widths: Sequence[int] = (32, 64, 128, 256),
    seed: int = 0,
) -> SmallCNN:
    """A SmallCNN in eval mode on seeded weights (the distributions of
    models/weights.py::init_state: convs and the dense N(0, 1/fan_in),
    BatchNorm identity, biases 0).  Its input size is free."""
    from .weights import seeded_state

    model = SmallCNN(num_outputs, widths, softmax).eval()
    model.load_state_dict(seeded_state(model, seed))
    return model
