"""Kernel B13 of the port (libultrahdr_dev_tpu_torch/ops/editor.py: crop,
mirror, rotate, resize and their chains) through its plain PyTorch
version on CPU tensors, against the JAX package's ops/editor.py on the
same seeded numpy planes.

Bars: every output plane bit-exact with JAX, with the same width and
height; every error the JAX package raises raised with the same code;
the CPU wrapper launches nothing."""

import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.ops import editor as je
from libultrahdr_dev_tpu.types import (PixelFormat as JPixelFormat,
                                       RawImage as JRawImage,
                                       UhdrError as JUhdrError)
from libultrahdr_dev_tpu_torch import PixelFormat, RawImage, UhdrError
from libultrahdr_dev_tpu_torch.ops import editor as te
import test_torch_threads  # noqa: F401  (caps torch's threads)


def _planes(fmt: str, h: int, w: int, seed: int) -> dict:
    """Seeded u8 planes of a YUV420 (ceil-half chroma) or monochrome
    image."""
    rng = np.random.default_rng(seed)
    planes = {"y": rng.integers(0, 256, (h, w), dtype=np.uint8)}
    if fmt == "YUV420":
        for k in ("u", "v"):
            planes[k] = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2),
                                     dtype=np.uint8)
    return planes


def _images(fmt: str, h: int, w: int, seed: int = 0):
    planes = _planes(fmt, h, w, seed)
    jimg = JRawImage(fmt=JPixelFormat[fmt], width=w, height=h,
                     planes=planes)
    timg = RawImage(fmt=PixelFormat[fmt], width=w, height=h,
                    planes={k: torch.from_numpy(p.copy())
                            for k, p in planes.items()})
    return jimg, timg


def _port(effects):
    """The JAX effects as the port's dataclasses."""
    kinds = {je.CropEffect: te.CropEffect, je.MirrorEffect: te.MirrorEffect,
             je.RotateEffect: te.RotateEffect,
             je.ResizeEffect: te.ResizeEffect}
    return [kinds[type(e)](**vars(e)) for e in effects]


def _assert_same(jout, tout):
    assert (tout.width, tout.height) == (jout.width, jout.height)
    assert set(tout.planes) == set(jout.planes)
    for k, p in jout.planes.items():
        np.testing.assert_array_equal(tout.planes[k].numpy(), np.asarray(p))


C, M, R, Z = je.CropEffect, je.MirrorEffect, je.RotateEffect, je.ResizeEffect
# (image h, w, chain): each effect alone, odd crops, resize up and down,
# chains of 2-5 steps.
CASES = [
    (40, 56, [C(8, 40, 4, 30)]),
    (40, 56, [C(3, 36, 5, 30)]),             # odd left / top snap to even
    (41, 57, [C(1, 56, 1, 40)]),             # odd image, odd window
    (40, 56, [C(0, 31, 0, 19)]),             # odd width and height
    (40, 56, [M("horizontal")]),
    (40, 56, [M("vertical")]),
    (40, 56, [R(90)]),
    (40, 56, [R(180)]),
    (40, 56, [R(270)]),
    (41, 57, [R(90)]),
    (40, 56, [Z(24, 16)]),                   # down
    (40, 56, [Z(90, 62)]),                   # up
    (40, 56, [Z(56, 40)]),                   # same size
    (40, 56, [C(4, 44, 2, 38), R(90)]),
    (40, 56, [R(270), M("horizontal"), Z(20, 28)]),
    (48, 64, [C(0, 64, 6, 42), R(90), M("horizontal"), Z(18, 32)]),
    (40, 56, [M("vertical"), C(2, 51, 0, 33), R(180), Z(30, 22),
              R(90)]),
    (41, 57, [C(3, 50, 1, 38), R(270), Z(36, 46), M("horizontal")]),
]


@pytest.mark.parametrize("fmt", ["YUV420", "MONOCHROME"])
@pytest.mark.parametrize("h,w,chain", CASES)
def test_effects_bit_exact_with_jax(fmt, h, w, chain):
    jimg, timg = _images(fmt, h, w, seed=h * w + len(chain))
    before = te.apply_effects.launches
    tout = te.apply_effects(timg, _port(chain))
    _assert_same(je.apply_effects(jimg, chain), tout)
    _assert_same(je.apply_effects(jimg, chain),
                 te.apply_effects_plain(timg, _port(chain)))
    assert te.apply_effects.launches == before
    if len(chain) == 1:   # the single-effect entry points
        fn = {C: "crop", M: "mirror", R: "rotate", Z: "resize"}[type(chain[0])]
        _assert_same(getattr(je, fn)(jimg, chain[0]),
                     getattr(te, fn)(timg, _port(chain)[0]))


def _random_chain(rng, h: int, w: int, n: int):
    """A valid chain of n effects on an (h, w) image, drawn from rng."""
    chain = []
    for _ in range(n):
        kind = rng.integers(4)
        if kind == 0 and h > 4 and w > 4:
            left, top = int(rng.integers(w - 3)), int(rng.integers(h - 3))
            right = int(rng.integers(left + 2, w + 1))
            bottom = int(rng.integers(top + 2, h + 1))
            chain.append(C(left, right, top, bottom))
            w, h = right - (left & ~1), bottom - (top & ~1)
        elif kind == 1:
            chain.append(M(("horizontal", "vertical")[rng.integers(2)]))
        elif kind == 2:
            deg = int((90, 180, 270)[rng.integers(3)])
            chain.append(R(deg))
            if deg != 180:
                h, w = w, h
        else:
            w, h = 2 * int(rng.integers(2, 40)), 2 * int(rng.integers(2, 40))
            chain.append(Z(w, h))
    return chain


_RNG = np.random.default_rng(1515)
# (image h, w, chain): ten seeded chains of 1-16 effects, odd and even
# image sizes.
RANDOM_CASES = [(h, w, _random_chain(_RNG, h, w, int(_RNG.integers(1, 17))))
                for h, w in ((37, 53), (40, 56), (33, 64), (64, 31), (45, 45),
                             (20, 90), (91, 22), (48, 48), (39, 70), (58, 41))]


@pytest.mark.parametrize("fmt,h,w,chain",
                         [("YUV420", *c) for c in CASES]
                         + [("MONOCHROME", *c) for c in RANDOM_CASES])
def test_axis_maps_gather_as_jax(fmt, h, w, chain):
    """editor.cu's premise: each plane's plan is one swap bit and two 1-D
    maps. The source plane gathered through axis_maps equals the JAX
    package's apply_effects output, plane by plane (the random chains
    on one plane, to keep JAX's compiles few)."""
    jimg, timg = _images(fmt, h, w, seed=h + w + len(chain))
    jout = je.apply_effects(jimg, chain)
    _, _, steps = te.plan_effects(timg, _port(chain))
    assert set(steps) == set(jout.planes)
    for k, plan in steps.items():
        swap, rows, cols = te.axis_maps(plan)
        assert rows.dtype == cols.dtype == torch.int64
        p = timg.planes[k]
        got = p[cols][:, rows].T if swap else p[rows][:, cols]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jout.planes[k]))


def test_chain_longer_than_one_launch():
    """A chain longer than the kernel's step array: the same result."""
    chain = [R(90), M("horizontal"), R(270), M("vertical")] * 5
    chain += [C(2, 50, 4, 36), Z(20, 16)]
    assert len(chain) > te.MAX_STEPS
    jimg, timg = _images("YUV420", 40, 56, seed=9)
    _assert_same(je.apply_effects(jimg, chain),
                 te.apply_effects(timg, _port(chain)))


def test_empty_chain_returns_the_image():
    jimg, timg = _images("YUV420", 16, 16)
    assert te.apply_effects(timg, []) is timg
    assert je.apply_effects(jimg, []) is jimg


@pytest.mark.parametrize("factor", [2, 4])
def test_scale_effects_matches_jax(factor):
    chain = [C(7, 93, 5, 61), M("vertical"), R(270), Z(3, 2), Z(120, 80)]
    got = te.scale_effects(_port(chain), factor)
    assert got == _port(je.scale_effects(chain, factor))


def _code(fn):
    with pytest.raises((UhdrError, JUhdrError)) as e:
        fn()
    return e.value.code


ERRORS = [
    ("YUV420", [C(0, 57, 0, 10)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [C(10, 10, 0, 10)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [C(-2, 10, 0, 10)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [R(90), C(0, 56, 0, 41)], "UHDR_CODEC_INVALID_PARAM"),
    ("MONOCHROME", [R(45)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [Z(0, 8)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [Z(9, 8)], "UHDR_CODEC_INVALID_PARAM"),
    ("YUV420", [M("vertical"), Z(8, -2)], "UHDR_CODEC_INVALID_PARAM"),
    ("P010", [M("horizontal")], "UHDR_CODEC_UNSUPPORTED_FEATURE"),
    ("P010", [C(0, 100, 0, 10)], "UHDR_CODEC_INVALID_PARAM"),
    ("RGBA8888", [R(90)], "UHDR_CODEC_UNSUPPORTED_FEATURE"),
]


@pytest.mark.parametrize("fmt,chain,code", ERRORS)
def test_error_codes_match_jax(fmt, chain, code):
    planes = _planes("YUV420" if fmt == "YUV420" else "MONOCHROME", 40, 56,
                     seed=1)
    jimg = JRawImage(fmt=JPixelFormat[fmt], width=56, height=40,
                     planes=planes)
    timg = RawImage(fmt=PixelFormat[fmt], width=56, height=40,
                    planes={k: torch.from_numpy(p) for k, p in planes.items()})
    assert _code(lambda: je.apply_effects(jimg, chain)) == code
    assert _code(lambda: te.apply_effects(timg, _port(chain))) == code


def test_unknown_effect_rejected():
    jimg, timg = _images("YUV420", 16, 16)
    assert _code(lambda: je.apply_effects(jimg, ["blur"])) == \
        _code(lambda: te.apply_effects(timg, ["blur"])) == \
        "UHDR_CODEC_INVALID_PARAM"


def test_plain_version_takes_any_dtype():
    """The plain chain moves values of any dtype as it moves bytes (the
    chip run holds the edited HDR decode against it in float)."""
    _, timg = _images("MONOCHROME", 40, 56, seed=3)
    chain = _port([C(4, 44, 2, 38), R(90), M("horizontal"), Z(18, 20)])
    as_u8 = te.apply_effects_plain(timg, chain).planes["y"]
    wide = RawImage(fmt=PixelFormat.MONOCHROME, width=56, height=40,
                    planes={"y": timg.planes["y"].to(torch.float32)})
    as_f32 = te.apply_effects_plain(wide, chain).planes["y"]
    assert torch.equal(as_f32.to(torch.uint8), as_u8)
