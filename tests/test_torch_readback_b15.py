"""B15, Rice pass 1 of the packed pixel readbacks, at 10 and 16 bits:
the port's rice_stats (its plain version on the CPU) against the JAX
package's _pass1_widths_fn / _pass1_both_fn, on smooth content and at
the edges (all zero, full-range noise, best k 15). Every comparison is
exact. The inputs and the per-test plan reset are
test_torch_readback.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from libultrahdr_dev_tpu.parallel import packio as jpackio
from libultrahdr_dev_tpu_torch.parallel import packio

import test_torch_threads  # noqa: F401  (caps torch's threads)

from test_torch_readback import (EDGE_CONTENT, SHAPES, _edge_src, _kset,
                                 _src, fresh_plans)  # noqa: F401


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("med", [False, True])
def test_b15_equals_jax_pass1(bits, shape, med):
    x, t = _src(bits, *shape, seed=1)
    (zs,), maps = packio.rice_stats(t, (med,))
    jzs, jmaps = jpackio._pass1_widths_fn(shape, bits, med)(jnp.asarray(x))
    assert np.array_equal(zs.numpy().view(np.uint16), np.asarray(jzs))
    assert np.array_equal(maps.numpy(), np.asarray(jmaps))


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_b15_both_schemes_equal_jax(bits, shape):
    x, t = _src(bits, *shape, seed=2)
    (zv, zm), maps = packio.rice_stats(t, (False, True))
    jzv, jzm, jmaps = jpackio._pass1_both_fn(shape, bits)(jnp.asarray(x))
    assert np.array_equal(zv.numpy().view(np.uint16), np.asarray(jzv))
    assert np.array_equal(zm.numpy().view(np.uint16), np.asarray(jzm))
    assert np.array_equal(maps.numpy(), np.asarray(jmaps))


@pytest.mark.parametrize("bits,content", EDGE_CONTENT)
def test_b15_edge_content_equals_jax(bits, content):
    """w = 200 < 256 (one partial segment a row), on the shape whose JAX
    pass 1 the tests above compile."""
    shape = SHAPES[0]
    x, t = _edge_src(bits, *shape, content, seed=5)
    (zv, zm), maps = packio.rice_stats(t, (False, True))
    jzv, jzm, jmaps = jpackio._pass1_both_fn(shape, bits)(jnp.asarray(x))
    assert np.array_equal(zv.numpy().view(np.uint16), np.asarray(jzv))
    assert np.array_equal(zm.numpy().view(np.uint16), np.asarray(jzm))
    assert np.array_equal(maps.numpy(), np.asarray(jmaps))
    codes = set(maps.numpy()[[0, 2]].ravel().tolist())
    if content == "zero":
        assert codes == {_kset(bits)[1]}
    if content == "k15":
        assert 15 in codes
