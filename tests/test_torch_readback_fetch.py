"""The packed pixel readbacks end to end at 10 bits (RGBA1010102): the
port's Rice fetches over three rounds (two-phase, then fused on the
cached plan) and its refusal of noise, against the JAX package's; and
the native unpacks, serial and threaded, against their numpy forms, at
10 and 16 bits. The 16-bit fetches over rounds are
test_torch_readback_fetch16.py's (a module of their own, so that
pytest-xdist's --dist loadfile runs the two widths' JAX compiles on two
workers). The inputs and the per-test plan reset are
test_torch_readback.py's."""

import jax.numpy as jnp
import numpy as np
import pytest

from libultrahdr_dev_tpu.parallel import packio as jpackio
from libultrahdr_dev_tpu_torch.parallel import packio

import test_torch_threads  # noqa: F401  (caps torch's threads)

from test_torch_readback import (FETCHES, _plan, _src,
                                 fresh_plans)  # noqa: F401


@pytest.mark.parametrize("bits", [10])
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


@pytest.mark.parametrize("bits", [10, 16])
def test_rice_fetch_declines_noise_as_jax(bits):
    x, t = _src(bits, 2, 64, 200, seed=6, noise=True)
    got = getattr(packio, FETCHES[bits][2])(t)
    want = getattr(jpackio, FETCHES[bits][2])(jnp.asarray(x))
    assert got[0] is None and want[0] is None and got[1] == want[1] > 0


@pytest.mark.parametrize("bits", [10, 16])
@pytest.mark.parametrize("med", [False, True])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_native_unpack_equals_numpy(bits, med, threads, monkeypatch):
    """uhdr_{rice,med}{,16}_unpack, serial and threaded, against the
    numpy tails (_rct_tail_numpy, _rct16_tail_numpy, _med10/16)."""
    monkeypatch.setenv("UHDR_UNPACK_THREADS", threads)
    n, h, w = 2, 40, 300
    x, t = _src(bits, n, h, w, seed=7)
    zs, kuw, plan = _plan(bits, t, med)
    rc, uc, rp, up, offs, _ = plan
    blob = packio.rice_pack(zs, kuw, offs, rp, up).numpy().view(np.uint32)
    km = kuw.numpy()
    native = packio._host_unpack_rice(blob, km[0], km[1], rp, up, n, h, w,
                                      med, bits)
    ref = packio._host_unpack_rice_numpy(blob, km[0], km[1], rc, uc, rp, up,
                                         n, h, w, med, bits)
    assert np.array_equal(native, x) and np.array_equal(ref, x)
