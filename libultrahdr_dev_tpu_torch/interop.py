"""Carry the JAX package's codec state into the port.

This system has no weights; the state both packages compute from is the
quantization tables and the gain-map metadata. These helpers take that
state as the JAX package holds it (numpy arrays, a dataclass of floats)
without importing that package, so tests can run both from identical
state.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import GainMapMetadata

_METADATA_FIELDS = ("version", "max_content_boost", "min_content_boost",
                    "gamma", "offset_sdr", "offset_hdr",
                    "hdr_capacity_min", "hdr_capacity_max")


def to_torch_qtables(*qtables, device="cuda") -> tuple[torch.Tensor, ...]:
    """8x8 (or 64) natural-order quant tables -> (64,) int32 tensors on
    `device`, the layout jpeg/dct.py's kernels take."""
    return tuple(torch.from_numpy(np.asarray(q, np.int32).reshape(64).copy())
                 .to(device) for q in qtables)


def metadata_from_jax(metadata) -> GainMapMetadata:
    """A GainMapMetadata of the port with the fields of `metadata` (any
    object with the JAX package's GainMapMetadata attributes)."""
    values = {k: getattr(metadata, k) for k in _METADATA_FIELDS}
    values["version"] = str(values["version"])
    for k in _METADATA_FIELDS[1:]:
        values[k] = float(values[k])
    return GainMapMetadata(**values)
