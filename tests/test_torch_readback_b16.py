"""B16, the Rice pack of the packed pixel readbacks, at 10 and 16 bits:
the port's two-phase rice_pack and fused rice_fused (their plain
versions on the CPU) against the JAX package's _rice_devpack_fn and
_fused_fetch_fn, on smooth content and at the edges, on exact and too
tight paddings. The edge cases reuse the paddings whose JAX functions
the fused cases compile, so they share this module's worker. Every
comparison is exact. The inputs and the per-test plan reset are
test_torch_readback.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from libultrahdr_dev_tpu.parallel import packio as jpackio
from libultrahdr_dev_tpu_torch.parallel import packio

import test_torch_threads  # noqa: F401  (caps torch's threads)

from test_torch_readback import (EDGE_CONTENT, SHAPES, _edge_src, _kset,
                                 _plan, _src, fresh_plans)  # noqa: F401


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("med", [False, True])
def test_b16_blob_equals_jax(bits, shape, med):
    x, t = _src(bits, *shape, seed=3)
    zs, kuw, plan = _plan(bits, t, med)
    rc, uc, rp, up, offs, est = plan
    want_plan = jpackio._rice_host_plan(kuw[0].numpy(), kuw[1].numpy(),
                                        *_kset(bits), 10**12)
    assert [np.array_equal(a, b) for a, b in zip(plan, want_plan)] == [
        True] * 6
    got = packio.rice_pack(zs, kuw, offs, rp, up)
    want = jpackio._rice_devpack_fn(zs.shape[0], rp, up, *_kset(bits))(
        jnp.asarray(zs.numpy().view(np.uint16)), jnp.asarray(kuw.numpy()),
        offs)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("tight", [False, True])
def test_b16_fused_equals_jax(bits, med, tight):
    """The fused buffer, on the exact plan and on one too tight for this
    batch (fit flag 0), as JAX's _fused_fetch_fn."""
    shape = (2, 64, 200)
    x, t = _src(bits, *shape, seed=4)
    _, _, plan = _plan(bits, t, med)
    rp, up = plan[2], plan[3]
    if tight:
        rp = tuple(max(32, r // 4) for r in rp)
    got = packio.rice_fused(t, med, rp, up)
    want = jpackio._fused_fetch_fn(shape, bits, med, rp, up)(jnp.asarray(x))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    hl = packio._head_len(len(rp))
    assert int(got[packio._fused_blob_words(rp, up)]) == int(not tight)
    assert hl == jpackio._fused_head_len(_kset(bits)[0])


@pytest.mark.parametrize("bits,content", EDGE_CONTENT)
@pytest.mark.parametrize("med", [False, True])
def test_b16_edge_content_fused_equals_jax(bits, content, med):
    """The fused buffer of the edge content on the static paddings that
    test_b16_fused_equals_jax compiles (the seed-4 plan, and its tight
    form), so no new JAX compile."""
    shape = (2, 64, 200)
    _, base = _src(bits, *shape, seed=4)
    plan = _plan(bits, base, med)[2]
    x, t = _edge_src(bits, *shape, content, seed=6)
    for rp in (plan[2], tuple(max(32, r // 4) for r in plan[2])):
        got = packio.rice_fused(t, med, rp, plan[3])
        want = jpackio._fused_fetch_fn(shape, bits, med, rp, plan[3])(
            jnp.asarray(x))
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
