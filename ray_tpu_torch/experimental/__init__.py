"""Experimental substrates: mutable-object channels (compiled-DAG
transport).

The port's copy of ``ray_tpu/experimental/__init__.py``.
"""
from .channel import Channel, ChannelClosed  # noqa: F401
