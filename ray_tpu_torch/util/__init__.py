"""Utilities of the port: :mod:`~ray_tpu_torch.util.tracing`, the span
buffer the serving engine and the batcher record into."""
