"""Command-line entry points of the port (``python -m rs_face_detection_tpu_torch.tools.<name>``)."""
