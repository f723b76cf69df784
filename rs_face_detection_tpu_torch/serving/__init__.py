"""Serving on one GPU: the batched detection server."""
