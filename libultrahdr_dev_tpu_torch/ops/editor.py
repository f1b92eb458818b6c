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
Each step maps each output axis to one input axis, so a plan is one swap
bit and two 1-D maps (axis_maps, the specification of the kernel's
walk). Then ONE launch of B13 (kernels/csrc/editor.cu) per image writes
every plane's output: each tile walks its rows and columns through the
steps once and copies. No intermediate plane reaches device memory. A
chain longer than the kernel's step array (MAX_STEPS) goes out as
successive launches.

Planes are 2-D torch tensors. ``edit_planes`` runs the plain version
(``edit_plane_plain``: torch slicing, flip, rot90 and index gathers) for
tensors on the CPU and the CUDA kernel for CUDA tensors; it counts
kernel launches (one per image and MAX_STEPS steps) in
``apply_effects.launches``. The plain version takes any dtype.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

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


def axis_maps(steps):
    """A plan as (swap, R, C): int64 tensors R over the output rows and C
    over the output columns with out[y][x] = src[R[y]][C[x]], or
    src[C[x]][R[y]] when swap. Each map runs the steps backwards, each
    step taking an output axis to one input axis (editor.cu:walk does the
    same per tile)."""
    oh, ow = _out_shape(steps)
    maps = []
    for axis, n in ((0, oh), (1, ow)):
        v = torch.arange(n, dtype=torch.int64)
        for kind, h, w, a, b, c, d in reversed(steps):
            if kind == CROP:
                v = v + (b if axis else a)
            elif kind == MIRROR:
                if axis == (1 if a else 0):
                    v = (w if axis else h) - 1 - v
            elif kind == ROTATE:
                if a == 180:
                    v = (w if axis else h) - 1 - v
                else:   # swaps the axes; 90 flips out columns, 270 rows
                    if (a == 90) == (axis == 1):
                        v = (h if a == 90 else w) - 1 - v
                    axis ^= 1
            else:
                v = v * (w if axis else h) // (d if axis else c)
        maps.append((axis, v))
    (row_axis, rows), (_, cols) = maps
    return row_axis == 1, rows, cols


class _Plan(NamedTuple):
    """A chain planned for one image: the result's size, the planes'
    names and steps, and per launch (MAX_STEPS steps) the output shapes
    and the kernel's int table (per plane: oh, ow, then 7 ints a step)."""

    width: int
    height: int
    names: list
    steps: list
    launches: list
    fits32: bool   # every resize's i * n_in fits 32 bits (editor.cu)


_PLANS: dict = {}


def _plan(img: RawImage, effects) -> _Plan:
    """plan_effects and the kernel's tables, memoized on the image's
    format, size and plane shapes and on the effects' values: the
    converter edits each frame and its gain map through one chain."""
    try:
        key = (img.fmt, img.width, img.height,
               tuple((k, *p.shape) for k, p in img.planes.items()),
               tuple((type(e), *vars(e).values()) for e in effects))
    except TypeError:   # not an effect: plan_effects raises
        key = None
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    width, height, steps = plan_effects(img, effects)
    names = list(steps)
    plans = [steps[k] for k in names]
    launches = []
    for i in range(0, len(plans[0]), MAX_STEPS):
        chunks = [s[i:i + MAX_STEPS] for s in plans]
        shapes = [_out_shape(c) for c in chunks]
        launches.append((shapes, np.array(
            [(*sh, *(v for st in c for v in st))
             for sh, c in zip(shapes, chunks)], np.int32)))
    fits32 = all(max((c - 1) * h, (d - 1) * w) < 1 << 32
                 for s in plans for kind, h, w, a, b, c, d in s
                 if kind == RESIZE)
    plan = _Plan(width, height, names, plans, launches, fits32)
    if key is not None:
        if len(_PLANS) >= 64:
            _PLANS.clear()
        _PLANS[key] = plan
    return plan


def _plain_planes(planes, plan: _Plan):
    return [edit_plane_plain(p, s) for p, s in zip(planes, plan.steps)]


def edit_planes(planes, plan: _Plan):
    """B13 wrapper: the planes of an image (2-D tensors, in plan.names'
    order) through the plan. The plain version for CPU tensors; for CUDA
    tensors (uint8, unit column stride) one kernel launch for all planes
    per MAX_STEPS steps. Returns the contiguous edited planes."""
    if not any(p.is_cuda for p in planes):
        return _plain_planes(planes, plan)
    for p in planes:
        if not p.is_cuda or p.dtype != torch.uint8 or p.dim() != 2 \
                or p.stride(1) != 1:
            raise ValueError("edit_planes: expected 2-D uint8 CUDA tensors "
                             "with unit column stride")
    if not plan.fits32:
        raise ValueError("edit_planes: resize beyond 32-bit indexing")
    dev = planes[0].device
    for shapes, ints in plan.launches:
        outs = [torch.empty(sh, dtype=torch.uint8, device=dev)
                for sh in shapes]
        ptrs = np.array([(p.data_ptr(), p.stride(0), o.data_ptr())
                         for p, o in zip(planes, outs)], np.int64)
        if any(o.numel() for o in outs):
            apply_effects.launches += 1
            build.launch(planes[0], "uhdr_edit_planes", ptrs.ctypes.data,
                         ints.ctypes.data, len(planes),
                         (ints.shape[1] - 2) // 7)
        planes = outs
    return planes


def _check_planes(img: RawImage):
    for name, p in img.planes.items():
        if not isinstance(p, torch.Tensor) or p.dim() != 2:
            raise ValueError(f"plane {name}: expected a 2-D torch tensor")


def _apply(img: RawImage, effects, edit) -> RawImage:
    if not effects:
        return img
    _check_planes(img)
    plan = _plan(img, effects)
    out = edit([img.planes[k] for k in plan.names], plan)
    return replace(img, width=plan.width, height=plan.height,
                   planes=dict(zip(plan.names, out)))


def apply_effects(img: RawImage, effects) -> RawImage:
    """Chain effects in order (editorhelper.cpp:362-446 addEffects): one
    B13 launch for all planes of the image (the plain version on the
    CPU). An empty chain returns `img` itself, as in the JAX package."""
    return _apply(img, effects, edit_planes)


apply_effects.launches = 0


def apply_effects_plain(img: RawImage, effects) -> RawImage:
    """apply_effects through the plain version, on any device."""
    return _apply(img, effects, _plain_planes)


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
