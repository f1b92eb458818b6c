"""The packed pixel readbacks end to end at 16 bits (F16 halves): the
port's Rice fetches over three rounds (two-phase, then fused on the
cached plan) against the JAX package's, the cases of
test_torch_readback_fetch.py's test at the other width. The inputs and
the per-test plan reset are test_torch_readback.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from libultrahdr_dev_tpu.parallel import packio as jpackio
from libultrahdr_dev_tpu_torch.parallel import packio

import test_torch_threads  # noqa: F401  (caps torch's threads)

from test_torch_readback import FETCHES, _src, fresh_plans  # noqa: F401


@pytest.mark.parametrize("bits", [16])
@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_rice_fetches_equal_jax_over_rounds(bits, scheme):
    """Three fetches of one shape (two-phase, then fused on the cached
    plan): the pixels come back bitwise and the bytes are JAX's."""
    name = FETCHES[bits][scheme]
    x, t = _src(bits, 2, 128, 600, seed=5)
    for _ in range(3):
        got, nbytes = getattr(packio, name)(t)
        want, jbytes = getattr(jpackio, name)(jnp.asarray(x))
        assert got is not None and np.array_equal(got, x)
        assert np.array_equal(got, want)
        if scheme < 2:   # auto may re-pick on timing once speeds are seen
            assert nbytes == jbytes
    assert packio.LAST_FETCH_STAGES["mode"] == "fused"
