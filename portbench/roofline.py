"""The least time an NVIDIA H100 could take for a stage's work.

The arithmetic of the repository's ``chip_smoke.py`` (``bound``,
``OPS``), copied so that the benchmark owns it, and recounted per
stage instead of per launch: a stage's bytes are its inputs read once
and its outputs written once, whatever its kernels pass between them,
so a change that fuses or splits kernels is read against the same work.

- Encode (API-0): every P010 input byte read once; the entropy-coded
  streams and their chunk bit counts written once. Operations: the
  gain map and BT.601 re-encode of the front end, the fDCT's three bf16
  tensor-core products and its float32 epilogue.
- Decode: the destuffed entropy streams read once; the output pixels
  written once (four bytes a pixel for RGBA1010102). Operations: the
  inverse DCT of every block and the gain-map apply, with its exactly
  rounded power laws counted as float64 operations.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # outside the tensor cores
FP64_FLOPS = 34e12        # outside the tensor cores
BF16_TC_FLOPS = 989e12    # dense bf16 on the tensor cores

# Float32 operations and exactly rounded power laws per sample, counted
# from the kernels' sources (chip_smoke.py OPS): a pow is POW_F64_OPS
# float64 operations.
POW_F64_OPS = 36
OPS = {
    # the apply, per output pixel
    "apply hlg": (81, 1), "apply pq": (81, 7),
    # the front end, per gain-map sample and per 2x2 quad of the
    # re-encode
    "map hlg": (114, 3), "map pq": (114, 9), "quad": (63, 0),
}
FDCT_TC_FLOPS = 3 * 2 * 64 * 64   # three bf16 products a block
FDCT_F32_FLOPS = 24 * 64          # tree, term sums and divide a block
IDCT_F32_FLOPS = 2048             # two 8x8 contractions a block


def p010_bytes(w: int, h: int) -> int:
    """A P010 frame: 16-bit luma and half-height interleaved CbCr."""
    return 2 * w * h + 2 * w * (h // 2)


def blocks(w: int, h: int) -> int:
    """8x8 blocks of a 4:2:0 base (luma and two chroma planes) and its
    quarter-size gain map, each plane padded to whole blocks."""
    def nb(pw, ph):
        return -(-pw // 8) * -(-ph // 8)

    return (nb(w, h) + 2 * nb(-(-w // 2), -(-h // 2))
            + nb(w // 4, h // 4))


def encode_stage(w: int, h: int, tf: str, frames: int,
                 stream_bytes: int) -> dict:
    """The work of `frames` API-0 encodes of w x h, whose entropy
    streams (with their bit counts) came to `stream_bytes` in all."""
    f_map, p_map = OPS[f"map {tf}"]
    f_quad, _ = OPS["quad"]
    samples = (w // 4) * (h // 4)
    quads = (w // 2) * (h // 2)
    nb = blocks(w, h)
    return dict(
        bytes=frames * p010_bytes(w, h) + stream_bytes,
        flops=frames * (f_map * samples + f_quad * quads
                        + FDCT_F32_FLOPS * nb),
        dflops=frames * p_map * POW_F64_OPS * samples,
        tc_flops=frames * FDCT_TC_FLOPS * nb)


def decode_stage(w: int, h: int, frames: int, stream_bytes: int,
                 out_bytes_per_px: int, apply_ops: tuple) -> dict:
    """The work of `frames` decodes of w x h JPEG/R, whose destuffed
    entropy streams came to `stream_bytes` in all, to pixels of
    `out_bytes_per_px` bytes, the apply costing `apply_ops` (float32
    operations, exactly rounded pows) a pixel."""
    f_px, p_px = apply_ops
    return dict(
        bytes=stream_bytes + frames * out_bytes_per_px * w * h,
        flops=frames * (f_px * w * h + IDCT_F32_FLOPS * blocks(w, h)),
        dflops=frames * p_px * POW_F64_OPS * w * h,
        tc_flops=0)


def least_seconds(work: dict) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    the memory rate and each kind of operation over its peak."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_ops = max(work["flops"] / FP32_FLOPS, work["dflops"] / FP64_FLOPS,
                work["tc_flops"] / BF16_TC_FLOPS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
