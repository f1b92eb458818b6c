"""Editing effects: crop / mirror / rotate / resize of raw images, kernel
B13.

Mirrors libultrahdr_dev_tpu/ops/editor.py (reference: editorhelper.cpp):
the four effect dataclasses, crop / mirror / rotate / resize /
apply_effects on YUV420 and monochrome RawImages, and scale_effects for
the quarter-resolution gain map, with the JAX package's checks and error
codes: left/top snapped to even values, the chroma crop
[top // 2, (top + h + 1) // 2) x [left // 2, (left + w + 1) // 2),
clockwise rotation, nearest-neighbour resize (i * ih) // oh on each
plane's own shape.

Design. The host plans the chain for each plane (plan_effects): it walks
the plane's own shapes effect by effect, as the JAX package applies one
effect after another to each plane, so chroma keeps its own odd or even
sizes, and it validates each effect where JAX does. A plane's plan is a
list of steps (kind, h, w, a, b, c, d): the shape before the step and
its parameters (crop: top, left, out h, out w; mirror: a = 1 for
horizontal; rotate: a = clockwise degrees; resize: c, d = out h, out w).
Then ONE launch of B13 (kernels/csrc/editor.cu) per plane writes the
plane's output: each output byte runs the steps in reverse to find its
source byte. No intermediate plane reaches device memory. A chain longer
than the kernel's step array (MAX_STEPS) goes out as successive
launches.

Planes are 2-D torch tensors. ``edit_plane`` runs the plain version
(``edit_plane_plain``: torch slicing, flip, rot90 and index gathers) for
a tensor on the CPU and the CUDA kernel for a CUDA tensor; it counts
kernel launches in ``apply_effects.launches``. The plain version takes
any dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels import build
from ..types import PixelFormat, RawImage, err

CROP, MIRROR, ROTATE, RESIZE = 0, 1, 2, 3
# Steps per launch (the kernel's step array, editor.cu:kMaxSteps).
MAX_STEPS = 16
# jnp.rot90's k (counterclockwise quarter turns) of a clockwise rotation.
_ROT90_K = {90: 3, 180: 2, 270: 1}


@dataclass
class CropEffect:
    """editorhelper.cpp:26-76: left/right/top/bottom in luma pixels
    (right/bottom exclusive); coordinates snap to even values for
    4:2:0 chroma alignment."""

    left: int
    right: int
    top: int
    bottom: int


@dataclass
class MirrorEffect:
    """editorhelper.cpp:78-170."""

    direction: str  # "horizontal" (left<->right) or "vertical"


@dataclass
class RotateEffect:
    """editorhelper.cpp:172-306; clockwise degrees in {90, 180, 270}."""

    degrees: int


@dataclass
class ResizeEffect:
    """editorhelper.cpp:308-360: nearest-neighbor to (width, height)."""

    width: int
    height: int


def _plane_names(img: RawImage):
    if img.fmt == PixelFormat.YUV420:
        return ["y", "u", "v"]
    if img.fmt == PixelFormat.MONOCHROME:
        return ["y"]
    raise err("UHDR_CODEC_UNSUPPORTED_FEATURE",
              f"effects unsupported for {img.fmt}")


def _slice(start: int, stop: int, n: int) -> tuple[int, int]:
    """(start, length) of Python's p[start:stop] on an axis of n."""
    start, stop = min(start, n), min(stop, n)
    return start, max(stop - start, 0)


def plan_effects(img: RawImage, effects):
    """Validate the chain as the JAX package does, effect by effect, and
    plan it: (width, height of the result, {plane name: [steps]}), each
    plane's steps walking that plane's own shapes."""
    width, height = img.width, img.height
    shapes = {k: tuple(img.planes[k].shape) for k in img.planes}
    steps = {}
    for e in effects:
        if isinstance(e, CropEffect):
            left, top = e.left & ~1, e.top & ~1
            right, bottom = e.right, e.bottom
            if not (0 <= left < right <= width
                    and 0 <= top < bottom <= height):
                raise err("UHDR_CODEC_INVALID_PARAM",
                          f"invalid crop window {e}")
            w, h = right - left, bottom - top

            def step(name, ph, pw):
                if name == "y":
                    r0, nr = _slice(top, bottom, ph)
                    c0, nc = _slice(left, right, pw)
                else:
                    r0, nr = _slice(top // 2, (top + h + 1) // 2, ph)
                    c0, nc = _slice(left // 2, (left + w + 1) // 2, pw)
                return (CROP, ph, pw, r0, c0, nr, nc), (nr, nc)
            width, height = w, h
        elif isinstance(e, MirrorEffect):
            horizontal = int(e.direction == "horizontal")

            def step(name, ph, pw):
                return (MIRROR, ph, pw, horizontal, 0, 0, 0), (ph, pw)
        elif isinstance(e, RotateEffect):
            if e.degrees not in _ROT90_K:
                raise err("UHDR_CODEC_INVALID_PARAM",
                          f"unsupported rotation {e.degrees}")
            deg = e.degrees

            def step(name, ph, pw):
                out = (pw, ph) if deg in (90, 270) else (ph, pw)
                return (ROTATE, ph, pw, deg, 0, 0, 0), out
            if deg in (90, 270):
                width, height = height, width
        elif isinstance(e, ResizeEffect):
            w, h = int(e.width), int(e.height)
            if w <= 0 or h <= 0 or w % 2 or h % 2:
                raise err("UHDR_CODEC_INVALID_PARAM",
                          f"invalid resize {w}x{h}")

            def step(name, ph, pw):
                oh, ow = (h, w) if name == "y" else (h // 2, w // 2)
                return (RESIZE, ph, pw, 0, 0, oh, ow), (oh, ow)
            width, height = w, h
        else:
            raise err("UHDR_CODEC_INVALID_PARAM",
                      f"unknown effect {type(e).__name__}")
        for name in _plane_names(img):
            s, shapes[name] = step(name, *shapes[name])
            steps.setdefault(name, []).append(s)
    return width, height, steps


def edit_plane_plain(p: torch.Tensor, steps) -> torch.Tensor:
    """A 2-D plane (any dtype) through planned steps, one torch operation
    each, as the JAX package applies the effects; contiguous."""
    for kind, h, w, a, b, c, d in steps:
        if kind == CROP:
            p = p[a:a + c, b:b + d]
        elif kind == MIRROR:
            p = torch.flip(p, (1 if a else 0,))
        elif kind == ROTATE:
            p = torch.rot90(p, _ROT90_K[a])
        else:
            rows = torch.arange(c, device=p.device) * h // c
            cols = torch.arange(d, device=p.device) * w // d
            p = p.index_select(0, rows).index_select(1, cols)
    return p.contiguous()


def _out_shape(steps) -> tuple[int, int]:
    kind, h, w, a, b, c, d = steps[-1]
    if kind in (CROP, RESIZE):
        return c, d
    if kind == ROTATE and a in (90, 270):
        return w, h
    return h, w


def edit_plane(p: torch.Tensor, steps) -> torch.Tensor:
    """B13 wrapper: the plain version for a CPU tensor; for a CUDA
    tensor, uint8 with unit column stride, one kernel launch per
    MAX_STEPS steps. Returns the contiguous edited plane."""
    if not p.is_cuda:
        return edit_plane_plain(p, steps)
    if p.dtype != torch.uint8 or p.dim() != 2 or p.stride(1) != 1:
        raise ValueError("edit_plane: expected a 2-D uint8 CUDA tensor "
                         "with unit column stride")
    lib = build.get_lib()
    for i in range(0, len(steps), MAX_STEPS):
        chunk = steps[i:i + MAX_STEPS]
        oh, ow = _out_shape(chunk)
        out = torch.empty((oh, ow), dtype=torch.uint8, device=p.device)
        if oh and ow:
            desc = np.ascontiguousarray(chunk, np.int32)
            apply_effects.launches += 1
            build.check(lib.uhdr_edit_plane(
                p.data_ptr(), p.stride(0), out.data_ptr(), oh, ow,
                desc.ctypes.data, len(chunk), build.stream_of(p)),
                "uhdr_edit_plane")
        p = out
    return p


def _check_planes(img: RawImage):
    for name, p in img.planes.items():
        if not isinstance(p, torch.Tensor) or p.dim() != 2:
            raise ValueError(f"plane {name}: expected a 2-D torch tensor")


def _apply(img: RawImage, effects, edit) -> RawImage:
    if not effects:
        return img
    _check_planes(img)
    width, height, steps = plan_effects(img, effects)
    return replace(img, width=width, height=height,
                   planes={k: edit(img.planes[k], s)
                           for k, s in steps.items()})


def apply_effects(img: RawImage, effects) -> RawImage:
    """Chain effects in order (editorhelper.cpp:362-446 addEffects): one
    B13 launch per plane (the plain version on the CPU). An empty chain
    returns `img` itself, as in the JAX package."""
    return _apply(img, effects, edit_plane)


apply_effects.launches = 0


def apply_effects_plain(img: RawImage, effects) -> RawImage:
    """apply_effects through the plain version, on any device."""
    return _apply(img, effects, edit_plane_plain)


def crop(img: RawImage, e: CropEffect) -> RawImage:
    return apply_effects(img, [e])


def mirror(img: RawImage, e: MirrorEffect) -> RawImage:
    return apply_effects(img, [e])


def rotate(img: RawImage, e: RotateEffect) -> RawImage:
    return apply_effects(img, [e])


def resize(img: RawImage, e: ResizeEffect) -> RawImage:
    return apply_effects(img, [e])


def scale_effects(effects, factor: int):
    """Rescale pixel-coordinate effects (crop/resize) for a plane at
    1/factor resolution (the gain map), keeping orientation effects
    unchanged (ultrahdr.cpp:997-1009, editor.py:133-149)."""
    out = []
    for e in effects:
        if isinstance(e, CropEffect):
            out.append(CropEffect(e.left // factor, e.right // factor,
                                  e.top // factor, e.bottom // factor))
        elif isinstance(e, ResizeEffect):
            out.append(ResizeEffect(max(e.width // factor, 1),
                                    max(e.height // factor, 1)))
        else:
            out.append(e)
    return out
