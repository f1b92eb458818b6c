"""Batched and multi-device paths: parallel/batched.py (the batched
entry points), parallel/mesh.py (the device mesh), parallel/link.py and
parallel/packio.py (the serving loop's host<->device links)."""

from .mesh import (DeviceMesh, ShardedBatch, default_mesh,  # noqa: F401
                   single_device_mesh)
