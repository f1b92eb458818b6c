"""Huffman encode on the device: kernels B3 / B12-enc (restart
intervals) and B19 (restart-less).

The port of libultrahdr_dev_tpu/jpeg/device_entropy.py's encoders:
``encode_ycbcr_rst_stream`` (any luma sampling) and
``encode_gray_rst_stream`` with ``cap_per_block=None``, plus the host
tail ``finalize_rst_stream``; and the restart-less ``encode_yuv420_stream``
/ ``encode_gray_stream`` (``_dc_prev_interleaved``, ``_units_for_blocks``,
``_assemble_bits``), plus their host tail ``_finalize``
(``finalize_stream`` here).

What B3 computes, per frame of a batch: the entropy-coded scan cut
into restart intervals of ``r_mcus`` MCUs (YCbCr: [Y x hs*vs, U, V] per
MCU, the luma blocks in raster order inside the MCU; gray: one block
per MCU), DC prediction reset at each interval (T.81 E.2.4), each
interval packed MSB-first and 1-filled to the next 32-bit boundary, its
bit count recorded, and the intervals laid back to back by word offset.
Its count pass also finds the longest block: the JAX encoder's
per-block buffer holds ``BLOCK_BIT_CAP`` bits, and its batched callers
write the whole batch restart-less when a block passes it, so a caller
that passes ``block_cap`` gets None instead of a stream then (the write
pass is not launched). Its kernels work in B19's tiles cut at the
intervals (``rst_tiling``): whole intervals a tile, or parts of one
long interval.

What B19 computes, per frame: the whole scan as one MSB-first bit
stream, DC predicted across the scan with no reset (each block from the
previous block of its component), the frame's last word 1-filled, each
frame starting on a word boundary, and the frame's bit count. Its
kernels work in tiles of ``RL_TILE`` blocks of one frame, read with
16-byte loads into shared memory; a block is coded by walking its
nonzero mask, and a per-frame scan of the tiles' bits (not of every
block) places the tiles.

Words are stored in JPEG byte order (big-endian), so a stream is a
plain byte buffer: the host copy needs no byte swap and the decoder
(B4, handoff mode) reads B3's chunks in place. The frames of a batch
follow one another in one buffer.

The MCU interleave (the JAX interleave_blocks_device) is index
arithmetic inside the kernels: they read the per-plane zigzag grids
that B2 writes. The JAX path's TPU workarounds (select chains,
log-doubling scans, the sort compaction and its word-cap / overflow
retry ladder, the serialized scatter) have no counterpart: the kernels
are exact for any int16 content on their one launch. Each wrapper runs
its plain PyTorch version for CPU tensors and the CUDA kernel
(kernels/csrc/huff_encode.cu) for CUDA tensors, and counts its
launches in ``.launches`` (B3's write passes also in
``.write_launches``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from . import dct, tables

# The JAX encoder's per-block word buffer holds (_BLOCK_WORDS - 1) * 32
# bits; a longer block raises its overflow flag (device_entropy.py:
# 361-372) and its batched callers fall back to restart-less JPEGs.
BLOCK_BIT_CAP = 608

# Blocks a B19 tile (a CTA of kernels/csrc/huff_encode.cu's rl_* passes),
# and the most a B3 tile holds.
RL_TILE = 256


def _build_code_table(bits, vals):
    """(code[256] u32, size[256] u8) canonical tables (T.81 Annex C)."""
    code = np.zeros(256, np.uint32)
    size = np.zeros(256, np.uint8)
    c = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            sym = vals[k]
            code[sym] = c
            size[sym] = length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _packed(bits, vals) -> np.ndarray:
    code, size = _build_code_table(bits, vals)
    return ((code.astype(np.int64) << 5) | size).astype(np.int32)


# [DC luma, AC luma, DC chroma, AC chroma], each entry (code << 5) | size;
# a symbol the table lacks has size 0 and emits only its extra bits, as
# the JAX lookup does.
CODE_TABLES = np.stack([
    _packed(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
    _packed(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
    _packed(tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS),
    _packed(tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)])


def n_chunks(n_mcus: int, r_mcus: int) -> int:
    return -(-n_mcus // r_mcus)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category of |v|, saturated at 15 (the JAX _bitlen)."""
    a = v.abs().to(torch.int64)
    n = torch.zeros_like(a)
    for b in range(16):
        n = torch.where(a >= (1 << b), b + 1, n)
    return torch.clamp(n, max=15)


def _magnitude_bits(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """T.81 F.1.2.1 extra bits of v in size category s."""
    e = torch.where(v >= 0, v, v + (1 << s) - 1)
    return e & ((1 << s) - 1)


def _units(blocks: torch.Tensor, dc_prev: torch.Tensor,
           luma: torch.Tensor, code_tables: torch.Tensor):
    """Per-block emission units, the JAX _units_for_blocks: (N, 64)
    int64 zigzag blocks, (N,) predicted DCs and (N,) luma flags ->
    (vals, lens), each (N, 65) int64: slot 0 the DC code+extra, slots
    1..63 an AC code+extra (or a ZRL at a zero position whose run
    since the last nonzero is a multiple of 16 and a nonzero follows),
    slot 64 the EOB when position 63 is zero."""
    n = blocks.shape[0]
    dev = blocks.device
    dc_tab = torch.where(luma[:, None], code_tables[0], code_tables[2])
    ac_tab = torch.where(luma[:, None], code_tables[1], code_tables[3])

    diff = blocks[:, 0] - dc_prev
    s = _bitlen(diff)
    e = torch.gather(dc_tab, 1, s[:, None])[:, 0]
    dc_val = ((e >> 5) << s) | _magnitude_bits(diff, s)
    dc_len = (e & 31) + s

    ac = blocks[:, 1:]
    nz = ac != 0
    k = torch.arange(1, 64, device=dev)[None, :]
    pos = torch.where(nz, k, 0)
    prev_incl = torch.cummax(pos, dim=1).values
    prevnz = torch.cat([torch.zeros((n, 1), dtype=pos.dtype, device=dev),
                        prev_incl[:, :-1]], dim=1)
    rel = k - prevnz
    later = torch.flip(torch.cummax(torch.flip(nz.to(torch.int64), [1]),
                                    dim=1).values, [1])
    has_later = torch.cat([later[:, 1:], torch.zeros(
        (n, 1), dtype=later.dtype, device=dev)], dim=1) > 0
    is_zrl = (~nz) & (rel % 16 == 0) & has_later
    sa = _bitlen(ac)
    sym = torch.where(nz, (((rel - 1) % 16) << 4) | sa,
                      torch.where(is_zrl, 0xF0, 0))
    a = torch.gather(ac_tab, 1, sym)
    sa_u = torch.where(nz, sa, 0)
    live = nz | is_zrl
    ac_val = torch.where(live, ((a >> 5) << sa_u)
                         | torch.where(nz, _magnitude_bits(ac, sa), 0), 0)
    ac_len = torch.where(live, (a & 31) + sa_u, 0)

    eob = ac_tab[:, 0]
    need_eob = pos.max(dim=1).values < 63
    vals = torch.cat([dc_val[:, None], ac_val,
                      torch.where(need_eob, eob >> 5, 0)[:, None]], dim=1)
    lens = torch.cat([dc_len[:, None], ac_len,
                      torch.where(need_eob, eob & 31, 0)[:, None]], dim=1)
    return vals, lens


def _assemble(vals, lens, lane, n_lanes: int):
    """Pack units (blocks in stream order, lane = their interval, or
    their frame for a restart-less scan) into one word-aligned,
    1-filled chunk per lane, chunks back to back: (JPEG-order bytes,
    (n_lanes,) int64 chunk bits)."""
    dev = vals.device
    blen = lens.sum(dim=1)
    bits = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    bits.index_add_(0, lane, blen)
    words = (bits + 31) >> 5
    word_off = torch.cumsum(words, 0) - words
    total = int(words.sum())
    # Start bit of each block inside its lane: exclusive running sum of
    # the block lengths, restarted at each lane.
    run = torch.cumsum(blen, 0) - blen
    lane_first = torch.cumsum(bits, 0) - bits
    start = word_off[lane] * 32 + run - lane_first[lane]
    unit_start = start[:, None] + torch.cumsum(lens, 1) - lens
    live = lens > 0
    p, v, ln = unit_start[live], vals[live], lens[live]
    v = v & ((1 << ln) - 1)
    # A unit ends `end` bits into its first word; past 32 it spills its
    # low end - 32 bits into the next word.
    end = (p & 31) + ln
    hi = torch.where(end <= 32, v << torch.clamp(32 - end, min=0),
                     v >> torch.clamp(end - 32, min=0))
    lo = torch.where(end > 32, (v << torch.clamp(64 - end, max=32))
                     & 0xFFFFFFFF, 0)
    out = torch.zeros(total + 1, dtype=torch.int64, device=dev)
    out.index_add_(0, p >> 5, hi)         # the bits are disjoint, so the
    out.index_add_(0, (p >> 5) + 1, lo)   # sums are ORs
    rem = bits & 31
    fill = torch.where(rem > 0, (1 << (32 - rem)) - 1, 0)
    out.index_add_(0, word_off + (bits >> 5), fill)
    out = out[:total]
    be = torch.stack([(out >> s) & 0xFF for s in (24, 16, 8, 0)], dim=1)
    return be.to(torch.uint8).reshape(-1), bits


def _code_tables(dev) -> torch.Tensor:
    """CODE_TABLES on `dev`, uploaded once per device: a pageable upload
    on every call would wait for the stream's earlier work."""
    return dct._on(dev, "huffman code tables", CODE_TABLES)


def _ycbcr_blocks(yz, uz, vz, mcus_x: int, mcus_y: int, sampling):
    """MCU-interleaved blocks (n, n_mcus, hs*vs + 2, 64) int64 of
    (n, hs*vs*n_mcus, 64) luma (mcus_y*vs x mcus_x*hs blocks) and
    (n, n_mcus, 64) chroma grids."""
    hs, vs = sampling
    n, nm = yz.shape[0], mcus_x * mcus_y
    yb = (yz.reshape(n, mcus_y, vs, mcus_x, hs, 64)
          .permute(0, 1, 3, 2, 4, 5).reshape(n, nm, hs * vs, 64))
    return torch.cat([yb, uz.reshape(n, nm, 1, 64),
                      vz.reshape(n, nm, 1, 64)], dim=2).to(torch.int64)


def _ycbcr_dc_prev(dc: torch.Tensor, ypm: int, r_mcus: int | None):
    """Predicted DC of each block of (n, n_mcus, ypm + 2) DCs: the
    previous block of its component in scan order, 0 at the first MCU of
    each restart interval (r_mcus None: of the scan only)."""
    prev = torch.zeros_like(dc)
    prev[:, :, 1:ypm] = dc[:, :, 0:ypm - 1]
    prev[:, 1:, 0] = dc[:, :-1, ypm - 1]
    prev[:, 1:, ypm:] = dc[:, :-1, ypm:]
    if r_mcus:
        first = (torch.arange(dc.shape[1], device=dc.device) % r_mcus) == 0
        prev[:, first, 0] = 0
        prev[:, first, ypm:] = 0
    return prev


def _gray_dc_prev(blocks: torch.Tensor, r_mcus: int | None):
    """Predicted DC of each block of (n, nb, 64) gray blocks."""
    n, nb = blocks.shape[:2]
    prev = torch.zeros((n, nb), dtype=torch.int64, device=blocks.device)
    prev[:, 1:] = blocks[:, :-1, 0]
    if r_mcus:
        prev[:, (torch.arange(nb, device=blocks.device) % r_mcus) == 0] = 0
    return prev


class _PlainCount:
    """A plain count pass: a batch's emission units (n frames of nc
    lanes), packed into their chunks by write(), whose chunk bits come
    as `bits_dtype` (int32 for B3, as its kernel writes them)."""

    def __init__(self, blocks, prev, luma, lane, n: int, nc: int,
                 bits_dtype=torch.int64):
        self.vals, self.lens = _units(
            blocks.reshape(-1, 64), prev.reshape(-1), luma.reshape(-1),
            _code_tables(blocks.device).to(torch.int64))
        self.lane, self.n, self.nc = lane, n, nc
        self.bits_dtype = bits_dtype

    @property
    def longest(self) -> int:
        """Bits of the batch's longest block."""
        return int(self.lens.sum(dim=1).max()) if self.lens.numel() else 0

    def write(self):
        """(stream bytes uint8, (n, nc) chunk bits)."""
        stream, bits = _assemble(self.vals, self.lens, self.lane,
                                 self.n * self.nc)
        return stream, bits.reshape(self.n, self.nc).to(self.bits_dtype)


def _finish(count, block_cap):
    """count.write(), or None (nothing written) when a block of the
    batch is longer than block_cap bits."""
    if block_cap is not None and count.longest > block_cap:
        return None
    return count.write()


def _ycbcr_count_plain(yz, uz, vz, mcus_x, mcus_y, sampling, r_mcus,
                       bits_dtype=torch.int64):
    blocks = _ycbcr_blocks(yz, uz, vz, mcus_x, mcus_y, sampling)
    n, nm, bpm = blocks.shape[:3]
    dev = blocks.device
    prev = _ycbcr_dc_prev(blocks[..., 0], bpm - 2, r_mcus)
    nc = n_chunks(nm, r_mcus) if r_mcus else 1
    chunk = (torch.arange(nm, device=dev) // r_mcus if r_mcus
             else torch.zeros(nm, dtype=torch.int64, device=dev))
    lane = ((torch.arange(n, device=dev)[:, None] * nc + chunk[None, :])
            [..., None].expand(n, nm, bpm).reshape(-1))
    luma = (torch.arange(bpm, device=dev) < bpm - 2).expand(n, nm, bpm)
    return _PlainCount(blocks, prev, luma, lane, n, nc, bits_dtype)


def _gray_count_plain(gz, r_mcus, bits_dtype=torch.int64):
    n, nb = gz.shape[:2]
    dev = gz.device
    blocks = gz.to(torch.int64)
    nc = n_chunks(nb, r_mcus) if r_mcus else 1
    chunk = (torch.arange(nb, device=dev) // r_mcus if r_mcus
             else torch.zeros(nb, dtype=torch.int64, device=dev))
    lane = (torch.arange(n, device=dev)[:, None] * nc
            + chunk[None, :]).reshape(-1)
    luma = torch.ones(n * nb, dtype=torch.bool, device=dev)
    return _PlainCount(blocks, _gray_dc_prev(blocks, r_mcus), luma, lane, n,
                       nc, bits_dtype)


def _ycbcr_plain(yz, uz, vz, mcus_x, mcus_y, sampling, r_mcus, block_cap):
    return _finish(_ycbcr_count_plain(yz, uz, vz, mcus_x, mcus_y, sampling,
                                      r_mcus), block_cap)


def _gray_plain(gz, r_mcus, block_cap):
    return _finish(_gray_count_plain(gz, r_mcus), block_cap)


def encode_ycbcr_rst_stream_plain(yz, uz, vz, mcus_x: int, mcus_y: int,
                                  r_mcus: int, sampling=(2, 2),
                                  block_cap: int | None = None):
    """(n, hs*vs*n_mcus, 64) luma and (n, n_mcus, 64) chroma int16
    zigzag grids of YCbCr frames at luma sampling (hs, vs) ((2, 2)
    4:2:0, (2, 1) 4:2:2, (1, 1) 4:4:4; mcus_y*vs x mcus_x*hs and
    mcus_y x mcus_x blocks) -> (stream bytes uint8, (n, nc) int32 chunk
    bits); frame f's chunks follow frame f-1's. None when block_cap is
    given and a block of the batch is longer than block_cap bits."""
    out = _ycbcr_plain(yz, uz, vz, mcus_x, mcus_y, sampling, r_mcus,
                       block_cap)
    return None if out is None else (out[0], out[1].to(torch.int32))


def encode_gray_rst_stream_plain(gz, r_mcus: int,
                                 block_cap: int | None = None):
    """(n, nblocks, 64) int16 zigzag grid in raster order, one block per
    MCU -> (stream bytes uint8, (n, nc) int32 chunk bits), or None as
    encode_ycbcr_rst_stream_plain."""
    out = _gray_plain(gz, r_mcus, block_cap)
    return None if out is None else (out[0], out[1].to(torch.int32))


def encode_ycbcr_stream_plain(yz, uz, vz, mcus_x: int, mcus_y: int,
                              sampling=(2, 2)):
    """B19's plain version: the grids of encode_ycbcr_rst_stream_plain
    -> (stream bytes uint8, (n,) int64 bits), each frame's scan with no
    restart interval, from a word boundary, its last word 1-filled."""
    stream, bits = _ycbcr_plain(yz, uz, vz, mcus_x, mcus_y, sampling, None,
                                None)
    return stream, bits[:, 0]


def encode_gray_stream_plain(gz):
    """B19's plain version for (n, nblocks, 64) gray grids -> (stream
    bytes uint8, (n,) int64 bits)."""
    stream, bits = _gray_plain(gz, None, None)
    return stream, bits[:, 0]


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _geometry(n: int, sampling, mcus_x: int, n_mcus: int, y, u):
    """The kernels' geometry arguments: n, color, hs, vs, mcus_x,
    n_mcus, blocks per frame of the first and of each chroma grid."""
    hs, vs = sampling or (1, 1)
    return (n, int(sampling is not None), hs, vs, mcus_x, n_mcus,
            y.shape[1], u.shape[1])


def rst_tiling(n_mcus: int, r_mcus: int, per_mcu: int):
    """B3's tiles of a frame: (K, P, T). A chunk is r_mcus * per_mcu
    blocks; K whole chunks a tile of at most RL_TILE blocks (P = 1), or
    for longer chunks P parts of RL_TILE blocks a chunk (K = 1); T
    tiles a frame."""
    cb = r_mcus * per_mcu
    nc = n_chunks(n_mcus, r_mcus)
    if cb <= RL_TILE:
        k = RL_TILE // cb
        return k, 1, -(-nc // k)
    p = -(-cb // RL_TILE)
    return 1, p, nc * p


class _RstCount:
    """B3's count pass on the device, its write pass not yet launched:
    the count pass + scan (launched at construction), then one sync
    for the total words, the longest block and the write pass's shared
    words (the first read of ``longest`` or ``write``)."""

    def __init__(self, wrapper, planes, nc: int, r_mcus: int, geom):
        y, u, v = planes
        dev = y.device
        n, color, hs, vs, _, n_mcus = geom[:6]
        per_mcu = hs * vs + 2 if color else 1
        k, p, t = rst_tiling(n_mcus, r_mcus, per_mcu)
        self.wrapper, self.planes, self.p = wrapper, planes, p
        self.tabs = _code_tables(dev)
        self.bits = torch.empty((n, nc), dtype=torch.int32, device=dev)
        self.blen = torch.empty(n * n_mcus * per_mcu, dtype=torch.int32,
                                device=dev)
        tval = torch.empty(n * t, dtype=torch.int32, device=dev)
        self.tbit = torch.empty(n * t, dtype=torch.int64, device=dev)
        self.meta = torch.empty(3, dtype=torch.int64, device=dev)
        self.args = (n, nc, r_mcus) + geom[1:] + (k, p, t)
        self._host = None
        build.launch(y, "uhdr_huff_encode_count", y.data_ptr(), u.data_ptr(),
                     v.data_ptr(), self.tabs.data_ptr(), self.bits.data_ptr(),
                     self.blen.data_ptr(), tval.data_ptr(),
                     self.tbit.data_ptr(), self.meta.data_ptr(), *self.args)
        wrapper.launches += 1

    def _read(self):
        if self._host is None:
            self._host = self.meta.tolist()  # the one sync
        return self._host

    @property
    def longest(self) -> int:
        """Bits of the batch's longest block."""
        return self._read()[1]

    def write(self):
        """The write pass: (stream bytes uint8, (n, nc) int32 bits)."""
        total, _, max_words = self._read()
        y, u, v = self.planes
        alloc = torch.zeros if self.p > 1 else torch.empty
        out = alloc(max(total, 1) * 4, dtype=torch.uint8, device=y.device)
        build.launch(y, "uhdr_huff_encode_write", y.data_ptr(), u.data_ptr(),
                     v.data_ptr(), self.tabs.data_ptr(), self.bits.data_ptr(),
                     self.blen.data_ptr(), self.tbit.data_ptr(),
                     out.data_ptr(), *self.args, max_words)
        self.wrapper.write_launches += 1
        return out[:total * 4], self.bits


def count_ycbcr_rst(yz, uz, vz, mcus_x: int, mcus_y: int, r_mcus: int,
                    sampling=(2, 2)):
    """B3's count pass alone over YCbCr frames (the grids of
    encode_ycbcr_rst_stream): a pending coding whose ``longest`` is
    the batch's longest block in bits (on the device, the pass's one
    sync) and whose ``write()`` runs the write pass -> (stream bytes
    uint8, (n, nc) int32 chunk bits). A caller that holds several
    batches (a mesh's shards) reads every count before it writes any,
    so that one decision over all of them picks the route."""
    if not yz.is_cuda:
        return _ycbcr_count_plain(yz, uz, vz, mcus_x, mcus_y, sampling,
                                  r_mcus, torch.int32)
    n, nm = yz.shape[0], mcus_x * mcus_y
    build.require(yz, "yz", torch.int16, (n, sampling[0] * sampling[1] * nm,
                                          64))
    build.require(uz, "uz", torch.int16, (n, nm, 64))
    build.require(vz, "vz", torch.int16, (n, nm, 64))
    return _RstCount(encode_ycbcr_rst_stream, (yz, uz, vz),
                     n_chunks(nm, r_mcus), r_mcus,
                     _geometry(n, tuple(sampling), mcus_x, nm, yz, uz))


def count_gray_rst(gz, r_mcus: int):
    """B3's count pass alone over single-component frames: as
    count_ycbcr_rst."""
    if not gz.is_cuda:
        return _gray_count_plain(gz, r_mcus, torch.int32)
    n, nb = gz.shape[:2]
    build.require(gz, "gz", torch.int16, (n, nb, 64))
    return _RstCount(encode_gray_rst_stream, (gz, gz, gz),
                     n_chunks(nb, r_mcus), r_mcus,
                     _geometry(n, None, nb, nb, gz, gz))


def encode_ycbcr_rst_stream(yz, uz, vz, mcus_x: int, mcus_y: int,
                            r_mcus: int, sampling=(2, 2),
                            block_cap: int | None = None):
    """B3 (B12-enc for 4:2:2 and 4:4:4) wrapper for YCbCr frames: the
    plain version on the CPU, the CUDA kernel on CUDA tensors: the
    count pass, its sync, then the write pass (none, and None
    returned, when a block passes block_cap). Same signature and
    result as encode_ycbcr_rst_stream_plain."""
    return _finish(count_ycbcr_rst(yz, uz, vz, mcus_x, mcus_y, r_mcus,
                                   sampling), block_cap)


encode_ycbcr_rst_stream.launches = 0
encode_ycbcr_rst_stream.write_launches = 0


def encode_gray_rst_stream(gz, r_mcus: int, block_cap: int | None = None):
    """B3 wrapper for single-component frames: the plain version on
    the CPU, the CUDA kernel on CUDA tensors. Same signature and result
    as encode_gray_rst_stream_plain."""
    return _finish(count_gray_rst(gz, r_mcus), block_cap)


encode_gray_rst_stream.launches = 0
encode_gray_rst_stream.write_launches = 0


def _launch_rl(wrapper, planes, geom):
    """B19: count pass (a CTA per 256-block tile: each block's bits and
    the tile's) + per-frame scan of the tile bits, one sync for the
    frames' bits and the total words, then the write pass into a zeroed
    buffer."""
    y, u, v = planes
    dev = y.device
    n, color, hs, vs, _, n_mcus = geom[:6]
    nb = n_mcus * (hs * vs + 2 if color else 1)
    ntiles = -(-nb // RL_TILE)
    tabs = _code_tables(dev)
    blen = torch.empty(n * nb, dtype=torch.int32, device=dev)
    tsum = torch.empty(n * ntiles, dtype=torch.int32, device=dev)
    toff = torch.empty(n * ntiles, dtype=torch.int64, device=dev)
    meta = torch.empty(n + 1, dtype=torch.int64, device=dev)
    build.launch(y, "uhdr_huff_encode_rl_count", y.data_ptr(), u.data_ptr(),
                 v.data_ptr(), tabs.data_ptr(), blen.data_ptr(),
                 tsum.data_ptr(), toff.data_ptr(), meta.data_ptr(), *geom)
    wrapper.launches += 1
    total = int(meta[n])  # the one sync: size the output exactly
    out = torch.zeros(max(total, 1) * 4, dtype=torch.uint8, device=dev)
    build.launch(y, "uhdr_huff_encode_rl_write", y.data_ptr(), u.data_ptr(),
                 v.data_ptr(), tabs.data_ptr(), blen.data_ptr(),
                 toff.data_ptr(), out.data_ptr(), *geom)
    return out[:total * 4], meta[:n]


def encode_ycbcr_stream(yz, uz, vz, mcus_x: int, mcus_y: int,
                        sampling=(2, 2)):
    """B19 wrapper for YCbCr frames: the plain version on the CPU, the
    CUDA kernel on CUDA tensors. Same signature and result as
    encode_ycbcr_stream_plain."""
    if not yz.is_cuda:
        return encode_ycbcr_stream_plain(yz, uz, vz, mcus_x, mcus_y,
                                         sampling)
    n, nm = yz.shape[0], mcus_x * mcus_y
    build.require(yz, "yz", torch.int16, (n, sampling[0] * sampling[1] * nm,
                                          64))
    build.require(uz, "uz", torch.int16, (n, nm, 64))
    build.require(vz, "vz", torch.int16, (n, nm, 64))
    return _launch_rl(encode_ycbcr_stream, (yz, uz, vz),
                      _geometry(n, tuple(sampling), mcus_x, nm, yz, uz))


encode_ycbcr_stream.launches = 0


def encode_gray_stream(gz):
    """B19 wrapper for single-component frames: the plain version on
    the CPU, the CUDA kernel on CUDA tensors. Same signature and result
    as encode_gray_stream_plain."""
    if not gz.is_cuda:
        return encode_gray_stream_plain(gz)
    n, nb = gz.shape[:2]
    build.require(gz, "gz", torch.int16, (n, nb, 64))
    return _launch_rl(encode_gray_stream, (gz, gz, gz),
                      _geometry(n, None, nb, nb, gz, gz))


encode_gray_stream.launches = 0


# ---------------------------------------------------------------------------
# Host tails.
# ---------------------------------------------------------------------------

def stream_spans(bits: np.ndarray) -> np.ndarray:
    """Byte offsets of each frame's scan in a B19 stream: (n + 1,)."""
    nbytes = 4 * ((np.asarray(bits, np.int64) + 31) >> 5)
    return np.concatenate([[0], np.cumsum(nbytes)])


def finalize_stream(stream: np.ndarray, bits: int) -> bytes:
    """Host tail of one frame's B19 output (the JAX _finalize): trim to
    whole bytes, 1-pad the last byte, stuff a 0x00 after every 0xFF.
    stream: the frame's bytes (JPEG order) from its first word on."""
    bits = int(bits)
    buf = np.array(np.asarray(stream, np.uint8)[:(bits + 7) // 8])
    if bits % 8:
        buf[-1] |= (1 << (8 - bits % 8)) - 1
    ff = np.flatnonzero(buf == 0xFF)
    if ff.size:
        buf = np.insert(buf, ff + 1, 0)
    return buf.tobytes()


def finalize_rst_stream(stream: np.ndarray, chunk_bits: np.ndarray) -> bytes:
    """Host tail of one frame's B3 output: strip each chunk's
    word-alignment fill, byte-stuff the data, join the chunks with
    RST0..7 markers. stream: the frame's compact chunk bytes (JPEG
    order, a multiple of 4 long); chunk_bits: its (nc,) bit counts.
    Vectorized (a per-chunk Python loop costs ~100 ms per 4K frame)."""
    chunk_bits = np.asarray(chunk_bits, np.int64)
    nc = len(chunk_bits)
    cwords = (chunk_bits + 31) >> 5
    dbytes = (chunk_bits + 7) >> 3
    word_bases = np.concatenate([[0], np.cumsum(cwords)])[:-1]
    raw = np.asarray(stream, np.uint8)[:int(cwords.sum()) * 4]

    # Keep only data bytes (drop per-chunk word-alignment fill).
    chunk_of = np.zeros(len(raw), np.int64)
    np.add.at(chunk_of, word_bases[1:] * 4, 1)
    chunk_of = np.cumsum(chunk_of)
    rel = np.arange(len(raw), dtype=np.int64) - word_bases[chunk_of] * 4
    keep = rel < dbytes[chunk_of]
    data = raw[keep]

    # Byte-stuff: 0x00 after every data 0xFF; chunk boundaries move by
    # the stuffed bytes of the chunks before them.
    ff_pos = np.flatnonzero(data == 0xFF)
    nff_per_chunk = (np.bincount(chunk_of[keep][ff_pos], minlength=nc)
                     if ff_pos.size else np.zeros(nc, np.int64))
    if ff_pos.size:
        data = np.insert(data, ff_pos + 1, 0)
    if nc == 1:
        return data.tobytes()

    bounds = np.cumsum(dbytes + nff_per_chunk)[:-1]
    markers = np.empty((nc - 1, 2), np.uint8)
    markers[:, 0] = 0xFF
    markers[:, 1] = 0xD0 + (np.arange(nc - 1) % 8)
    return np.insert(data, np.repeat(bounds, 2),
                     markers.reshape(-1)).tobytes()
