"""rs_face_detection_tpu_torch — the face-ID and eKYC pipelines in PyTorch and CUDA.

The port of ``rs_face_detection_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  It mirrors that package's layout (``configs``, ``ops/``, ``models/``,
``pipeline/``, ``utils/``) and adds ``csrc/`` (CUDA sources), ``kernels/``
(their build and wrappers) and ``tools/`` (scripts for the card).  It
imports torch and numpy, never JAX nor any module of the JAX package, and
its entry points run on the CUDA card unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
