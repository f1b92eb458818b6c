"""Blockwise 8x8 DCT / IDCT + (de)quantization: kernels B2 and B5.

``fdct_quant`` (B2) replaces libultrahdr_dev_tpu/jpeg/dct.py:fdct_zigzag
as parallel/sharding.py:_fdct_zigzag calls it (edge padding to
multiples of 8 included); ``dequant_idct`` (B5) replaces
dct.py:_idct_kernel / dequant_idct. Each wrapper runs its plain PyTorch
version for a tensor on the CPU and the hand-written CUDA kernel
(kernels/csrc/dct.cu) for a CUDA tensor, and counts its kernel launches
in ``.launches``.

B2 computes JAX's kron form bit for bit: the three bf16 terms of
kron(D, D) (columns in zigzag order, ``KRON_ZIG``) times the bf16
samples, each dot the pairwise float32 tree over the block's 8 exact
row sums, then (d0 + d1) + d2, / q, rounded half to even. JAX's encode
programs (parallel/sharding.py:_gainmap_and_coefs) hold their quant
tables as constants, and XLA divides by a constant as a product with
its float32 reciprocal; ``recip=True`` takes that form, which differs
from the quotient on exact ties (-45.5 / 7 rounds to -6, -45.5 *
RN(1/7) to -7). On the card
each row sum is one bf16 ``mma.sync`` on the tensor cores with a zero
accumulator (``kron_mma_fragments`` lays the terms out as its B
operands); it is exact because no row sum of any input spans 24 bits
(tests/test_torch_dct.py::test_kron_row_sums_fit_float32). The tree,
the division and the rounding run on the CUDA cores. B5 keeps the
first kernel's arithmetic, so its pixels: dequantise, contract the
vertical frequency u first, then v, each sum in order with separately
rounded products. The source note in dct.cu says what bounds the
kernels and how they are laid out on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import build
from .tables import ZIGZAG


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix: F = D @ x."""
    d = np.zeros((8, 8), np.float64)
    for u in range(8):
        cu = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            d[u, x] = cu * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return d


_D64 = _dct_matrix()
# Float32 DCT matrix of the inverse transform (the JAX IDCT's `d`).
D32 = _D64.astype(np.float32)
ZIG = np.asarray(ZIGZAG, np.int64)
INV_ZIG = np.argsort(ZIG)


def _bf16(m: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), kept as
    float32."""
    b = m.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _kron_zig_split() -> np.ndarray:
    """(3, 64, 64) float32: kron(D, D) acting on a flattened block, its
    columns in zigzag order, split into three bfloat16 terms (each the
    bf16 rounding of the remaining float32 residual), as the JAX
    package's dct.py:_kron_fdct_bf16_split builds them."""
    rem = np.kron(_D64, _D64).astype(np.float32).T[:, ZIG]
    terms = []
    for _ in range(3):
        t = _bf16(rem)
        terms.append(t)
        rem = rem - t
    return np.ascontiguousarray(np.stack(terms))


KRON_ZIG = _kron_zig_split()


def kron_mma_fragments() -> np.ndarray:
    """KRON_ZIG as the B operands of B2's m16n8k8 bf16 ``mma.sync``:
    (3 terms, 8 column groups j, 2 row halves, 32 lanes, 4 rows) uint32.
    Row r = 4 * half + i of the block; lane 4 g + t holds the bf16 bits
    (the terms' high halves: their low halves are zero) of
    KRON_ZIG[term, 8 r + 2 t, 8 j + g] in its low 16 bits and of
    KRON_ZIG[term, 8 r + 2 t + 1, 8 j + g] in its high 16 bits, so a
    lane reads its four rows' fragments as one 16-byte word."""
    hi = KRON_ZIG.view(np.uint32) >> 16
    # (term, half, i, t, k, j, g): row 4 half + i, sample 2 t + k,
    # column 8 j + g.
    h = hi.reshape(3, 2, 4, 4, 2, 8, 8)
    word = h[:, :, :, :, 0] | (h[:, :, :, :, 1] << 16)
    return np.ascontiguousarray(
        word.transpose(0, 4, 1, 5, 3, 2).reshape(3, 8, 2, 32, 4))


def kron_adversarial_rows() -> np.ndarray:
    """(3 terms, 8 rows, 64 output columns, 2, 8) int64: for each row of
    each term of KRON_ZIG and each output column, two rows of
    level-shifted samples in [-128, 127] whose row sums span the most
    bits: the largest |row sum| (every sample at an end of the range,
    against its weight's sign) and the widest cancellation (127 times
    each weight's sign, the largest weight's sign flipped)."""
    w = KRON_ZIG.reshape(3, 8, 8, 64).transpose(0, 1, 3, 2).astype(np.float64)
    s = np.sign(w).astype(np.int64)
    neg = np.where(s > 0, -128, 127) * (s != 0)
    pos = np.where(s < 0, -128, 127) * (s != 0)
    big = np.where((np.abs((neg * w).sum(-1)) >= np.abs((pos * w).sum(-1)))
                   [..., None], neg, pos)
    flip = 127 * s
    top = np.abs(w).argmax(-1)[..., None]
    np.put_along_axis(flip, top, -np.take_along_axis(flip, top, -1), -1)
    return np.stack([big, flip], axis=3)


# Host copies for the kernels' by-value table argument.
_D_C = np.ascontiguousarray(D32.reshape(64))
_INV_ZIG_C = np.ascontiguousarray(INV_ZIG.astype(np.int32))
_FRAGS_C = kron_mma_fragments().view(np.int32)
_ON_DEVICE: dict = {}


def _on(device, name: str, host: np.ndarray) -> torch.Tensor:
    """A constant table on `device`, uploaded once per device (keyed by
    its index)."""
    key = (resolve_device(device), name)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = torch.from_numpy(host).to(key[0])
    return t


def _tables():
    fp = ctypes.POINTER(ctypes.c_float)
    return (_D_C.ctypes.data_as(fp),
            _INV_ZIG_C.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))


def blocks_dims(h: int, w: int) -> tuple[int, int]:
    """Block-grid dims (bh, bw) of an (h, w) plane padded to 8."""
    return -(-h // 8), -(-w // 8)


# ---------------------------------------------------------------------------
# B2: forward DCT + quantization + zigzag.
# ---------------------------------------------------------------------------

def _tree8(r: torch.Tensor) -> torch.Tensor:
    """((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) over dim 0."""
    return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))


def fdct_quant_plain(plane_u8: torch.Tensor, q_natural: torch.Tensor,
                     recip: bool = False) -> torch.Tensor:
    """(n, h, w) uint8 planes -> (n, bh*bw, 64) int16 quantized
    coefficients in zigzag order. The plane is edge-padded to multiples
    of 8; q_natural is the (64,) int32 quant table in natural order.

    The JAX package's value, bit for bit: each of its three bf16 dots
    sums the 64 products as a pairwise tree in float32. A row of the
    block (8 products) sums exactly in float32 in any order (an 8-bit
    sample times a bf16 term has 16 significant bits, and a row's sum
    stays within 24), so the row sums are exact and only the tree over
    the 8 rows rounds; then (d0 + d1) + d2, / q (with recip, times the
    float32 1 / q), rounded half to even."""
    n, h, w = plane_u8.shape
    bh, bw = blocks_dims(h, w)
    dev = plane_u8.device
    rows = torch.clamp(torch.arange(bh * 8, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(bw * 8, device=dev), max=w - 1)
    x = plane_u8.index_select(1, rows).index_select(2, cols)
    x = x.to(torch.float32) - 128.0
    # (8 rows, n * blocks, 8 cols): row j of every block.
    xb = (x.reshape(n, bh, 8, bw, 8).permute(2, 0, 1, 3, 4)
          .reshape(8, n * bh * bw, 8))
    m = _on(dev, "kron", KRON_ZIG).reshape(3, 8, 8, 64)
    d = [_tree8(torch.bmm(xb, m[t])) for t in range(3)]
    c = ((d[0] + d[1]) + d[2]).reshape(n, bh * bw, 64)
    q = q_natural.to(device=dev, dtype=torch.float32).reshape(64)
    q_zig = q[torch.from_numpy(ZIG).to(dev)]
    if recip:
        return torch.round(c * (1.0 / q_zig)).to(torch.int16)
    return torch.round(c / q_zig).to(torch.int16)


def fdct_quant(plane_u8: torch.Tensor, q_natural: torch.Tensor,
               recip: bool = False) -> torch.Tensor:
    """B2 wrapper: the plain version on the CPU, the CUDA kernel on a
    CUDA tensor. Same signature and result as fdct_quant_plain."""
    if not plane_u8.is_cuda:
        return fdct_quant_plain(plane_u8, q_natural, recip)
    n, h, w = plane_u8.shape
    build.require(plane_u8, "plane", torch.uint8)
    build.require(q_natural, "q_natural", torch.int32, (64,))
    bh, bw = blocks_dims(h, w)
    out = torch.empty((n, bh * bw, 64), dtype=torch.int16,
                      device=plane_u8.device)
    frags = _on(plane_u8.device, "frags", _FRAGS_C)
    fdct_quant.launches += 1
    build.launch(plane_u8, "uhdr_fdct_quant", plane_u8.data_ptr(),
                 q_natural.data_ptr(), frags.data_ptr(), out.data_ptr(), n, h,
                 w, int(recip), *_tables())
    return out


fdct_quant.launches = 0


def kron_row_sums_plain(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) uint8 blocks -> (N, 3, 8, 64) float32: for each term of
    KRON_ZIG, block row and output column, the exact sum of the row's 8
    products (in float64, then float32: no row sum spans 24 bits)."""
    x = blocks.to(torch.float64) - 128.0
    m = torch.from_numpy(KRON_ZIG).to(x.device, torch.float64)
    return torch.einsum("nrc,trco->ntro", x,
                        m.reshape(3, 8, 8, 64)).to(torch.float32)


def mma_row_sums(blocks: torch.Tensor) -> torch.Tensor:
    """The row sums of kron_row_sums_plain as B2's tensor-core ``mma``
    gives them on a CUDA tensor (uhdr_mma_row_sums, the premise B2's
    exactness rests on, which only the card can show); the plain version
    on the CPU. N must be a multiple of 16. Not on any path: a check."""
    if not blocks.is_cuda:
        return kron_row_sums_plain(blocks)
    n = blocks.shape[0]
    build.require(blocks, "blocks", torch.uint8, (n, 8, 8))
    if n % 16:
        raise ValueError("blocks: expected a multiple of 16")
    t = n // 16
    tiles = blocks.reshape(t, 16, 8, 8).permute(0, 2, 1, 3).contiguous()
    out = torch.empty((t, 3, 8, 8, 32, 4), dtype=torch.float32,
                      device=blocks.device)
    build.launch(blocks, "uhdr_mma_row_sums", tiles.data_ptr(),
                 _on(blocks.device, "frags", _FRAGS_C).data_ptr(),
                 out.data_ptr(), t)
    # (tile, term, j, row, g, tq, half, k) -> block 8 half + g, column
    # 8 j + 2 tq + k.
    return (out.reshape(t, 3, 8, 8, 8, 4, 2, 2)
            .permute(0, 6, 4, 1, 3, 2, 5, 7).reshape(n, 3, 8, 64))


# ---------------------------------------------------------------------------
# B5: dequantization + inverse DCT.
# ---------------------------------------------------------------------------

def dequant_idct_plain(coefs: torch.Tensor, q_natural: torch.Tensor,
                       bh: int, bw: int) -> torch.Tensor:
    """(n, bh*bw, 64) int16 zigzag coefficients and (n, 64) int32 quant
    tables in natural order -> (n, bh*8, bw*8) uint8 planes."""
    n = coefs.shape[0]
    dev = coefs.device
    nat = coefs[..., torch.from_numpy(INV_ZIG).to(dev)].to(torch.float32)
    q = q_natural.to(device=dev, dtype=torch.float32).reshape(n, 1, 64)
    f = (nat * q).reshape(n, bh * bw, 8, 8)
    d = torch.from_numpy(D32).to(dev)
    # X = D^T F D, contracting the vertical frequency u first.
    pix = torch.matmul(torch.matmul(d.T, f), d)
    pix = torch.clamp(torch.round(pix + 128.0), 0, 255).to(torch.uint8)
    return (pix.reshape(n, bh, bw, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n, bh * 8, bw * 8))


def dequant_idct(coefs: torch.Tensor, q_natural: torch.Tensor, bh: int,
                 bw: int) -> torch.Tensor:
    """B5 wrapper: the plain version on the CPU, the CUDA kernel on a
    CUDA tensor. Same signature and result as dequant_idct_plain."""
    if not coefs.is_cuda:
        return dequant_idct_plain(coefs, q_natural, bh, bw)
    n = coefs.shape[0]
    build.require(coefs, "coefs", torch.int16, (n, bh * bw, 64))
    build.require(q_natural, "q_natural", torch.int32, (n, 64))
    if coefs.data_ptr() % 16:
        raise ValueError("coefs: expected a 16-byte aligned tensor")
    out = torch.empty((n, bh * 8, bw * 8), dtype=torch.uint8,
                      device=coefs.device)
    dequant_idct.launches += 1
    build.launch(coefs, "uhdr_dequant_idct", coefs.data_ptr(),
                 q_natural.data_ptr(), out.data_ptr(), n, bh, bw, *_tables())
    return out


dequant_idct.launches = 0
