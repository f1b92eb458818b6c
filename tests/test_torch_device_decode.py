"""Kernel B4 of the port (libultrahdr_dev_tpu_torch/jpeg/device_decode.py:
parallel restart-interval Huffman decode) through its plain PyTorch
version, against the JAX package's decode_rst_chunks and
parse_device_stream and against the host Huffman decoder, on the same
streams; and the port's decode routes (device, host, handoff) against
each other on CPU tensors.

All comparisons are exact: coefficient grids, parsed stream fields, and
decoded pixels bit for bit."""

import os
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from libultrahdr_dev_tpu.jpeg import device_decode as jdd
from libultrahdr_dev_tpu_torch import JpegR, OutputFormat, UhdrError
from libultrahdr_dev_tpu_torch.container import mux
from libultrahdr_dev_tpu_torch.jpeg import codec, device_decode as tdd, headers
from libultrahdr_dev_tpu_torch.jpeg import device_entropy as tde, tables
from libultrahdr_dev_tpu_torch.parallel import batched

import test_torch_jax_native  # noqa: F401  (loads the JAX native codec)
import test_torch_threads  # noqa: F401  (caps torch's threads)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLDEN_NAMES = sorted(n for n in os.listdir(GOLDENS) if n.startswith("enc0"))
H, W = 112, 144
MX, MY = W // 16, H // 16


def _rand_blocks(nb, seed, density=0.15):
    rng = np.random.default_rng(seed)
    b = np.zeros((nb, 64), np.int16)
    b[:, 0] = rng.integers(-300, 300, nb)
    m = rng.random((nb, 63)) < density
    b[:, 1:] = np.where(m, rng.integers(-60, 60, (nb, 63)), 0)
    return b


def _own_streams():
    """A 4:2:0 JPEG and a gray JPEG written by B3 (plain) + its host
    tail, with restart interval 4."""
    nm = MX * MY
    y, u, v = (_rand_blocks(n, s) for n, s in ((4 * nm, 1), (nm, 2),
                                              (nm, 3)))
    st, bits = tde.encode_ycbcr_rst_stream(
        *(torch.from_numpy(a)[None] for a in (y, u, v)), MX, MY, 4)
    color = (codec.yuv420_jpeg_headers(W, H, 95, restart_interval=4)
             + tde.finalize_rst_stream(st.numpy(), bits[0].numpy())
             + b"\xff\xd9")
    g = _rand_blocks(4 * 5, 4)
    st, bits = tde.encode_gray_rst_stream(torch.from_numpy(g)[None], 4)
    gray = (codec.gray_jpeg_headers(36, 28, 85, restart_interval=4)
            + tde.finalize_rst_stream(st.numpy(), bits[0].numpy())
            + b"\xff\xd9")
    return {"color": color, "gray": gray}


# Optimized-style tables whose shortest codes are 1 bit long: DC size 0
# and the AC EOB get the code "0".
ONE_BIT_DC = ([1] * 12 + [0] * 4, list(range(12)))
ONE_BIT_AC = ([1, 0, 0, 0, 0, 0, 0, 0, 161] + [0] * 7,
              [0] + [s for s in tables.AC_LUMA_VALS if s != 0])


def _one_bit_jpeg(quality=60, seed=7):
    """A 4:2:0 JPEG with restart interval 4 whose DHTs carry 1-bit
    codes, written by the host coder."""
    nm = MX * MY
    rng = np.random.default_rng(seed)
    blocks = np.zeros((nm * 6, 64), np.int16)
    blocks[::3, 0] = rng.integers(-5, 5, len(blocks[::3]))
    blocks[::5, 1] = rng.integers(-3, 4, len(blocks[::5]))
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), nm)
    scan = codec.entropy_encode(blocks, comp, [0, 1, 1], [0, 1, 1],
                                [ONE_BIT_DC, ONE_BIT_DC],
                                [ONE_BIT_AC, ONE_BIT_AC], 4, 6)
    ql = tables.scale_quant_table(tables.STD_LUMINANCE_QUANT, quality)
    qc = tables.scale_quant_table(tables.STD_CHROMINANCE_QUANT, quality)
    m = codec._marker
    hdr = (b"\xff\xd8" + codec._jfif_app0()
           + m(0xDB, codec._dqt(0, ql)) + m(0xDB, codec._dqt(1, qc))
           + m(0xC0, codec._sof0(W, H, [(1, 2, 2, 0), (2, 1, 1, 1),
                                        (3, 1, 1, 1)]))
           + b"".join(m(0xC4, codec._dht(c, t, *spec)) for c, spec in
                      ((0, ONE_BIT_DC), (1, ONE_BIT_AC)) for t in (0, 1))
           + m(0xDD, (4).to_bytes(2, "big"))
           + m(0xDA, codec._sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)])))
    return hdr + scan + b"\xff\xd9"


def _golden_part(name, k):
    blob = open(os.path.join(GOLDENS, name), "rb").read()
    return mux.extract_primary_and_gainmap(blob)[k]


def _windows(ds):
    """(lanes, win) u8 lane windows as the JAX device path gathers them:
    the destuffed stream from each lane's start, zero past its end."""
    padded = np.concatenate([ds.dest, np.zeros(ds.win_len, np.uint8)])
    return padded[ds.starts_byte[:, None]
                  + np.arange(ds.win_len)[None, :]]


@lru_cache(maxsize=None)
def _jax_kernel(r, n_mcus, gray, tkey, carry, units):
    chains = jdd.chains_from_key(tkey) if tkey else None
    mcb = jdd.min_code_len_from_key(tkey)
    return jax.jit(lambda ch, sb: jdd.decode_rst_chunks(
        ch, r, n_mcus, gray, chains, mcb, start_bits=sb if carry else None,
        dc_carry=carry, units_per_step=units))


def _jax_grids(ch, r, mcus_x, mcus_y, gray, tkey=None, start_bits=None,
               units=None):
    carry = start_bits is not None
    sb = start_bits if carry else np.zeros(ch.shape[0], np.int32)
    out = np.asarray(_jax_kernel(r, mcus_x * mcus_y, gray, tkey, carry,
                                 units)(ch, sb))
    if gray:
        return (out[:mcus_x * mcus_y],)
    return tuple(np.asarray(p) for p in jdd.deinterleave_ycbcr_device(
        out, mcus_x, mcus_y))


def _port_grids(streams):
    ln = tdd.pack_streams(streams)
    return tdd.decode_rst_chunks(
        *(torch.from_numpy(a) for a in (ln.src, ln.frames, ln.lanes,
                                        ln.tables)),
        ln.gray, ln.sampling, ln.mcus_x, ln.mcus_y)


def _host_grids(data):
    dec = codec.decode_jpeg_coefs(data)
    return tuple(c[0].reshape(-1, 64) for c in dec.comps)


def _assert_grids(port, want):
    assert len(port) == len(want)
    for p, w in zip(port, want):
        np.testing.assert_array_equal(p[0].numpy(), w)


# ---------------------------------------------------------------------------
# Host parse.
# ---------------------------------------------------------------------------

def _all_inputs():
    own = _own_streams()
    out = {k: own[k] for k in own}
    out["one_bit"] = _one_bit_jpeg()
    out["golden_base"] = _golden_part("enc0_709_hlg.jpegr", 0)
    out["golden_gm"] = _golden_part("enc0_709_hlg.jpegr", 1)
    return out


@pytest.mark.parametrize("which", ["color", "gray", "one_bit",
                                   "golden_base", "golden_gm"])
def test_parse_matches_jax(which):
    data = _all_inputs()[which]
    ours, theirs = tdd.parse_device_stream(data), jdd.parse_device_stream(
        data)
    assert ours is not None and theirs is not None
    np.testing.assert_array_equal(ours.dest, theirs.dest)
    np.testing.assert_array_equal(ours.starts_byte, theirs.starts_byte)
    assert ours.win_len == theirs.win_len
    if theirs.start_bits is None:
        assert ours.start_bits is None
    else:
        np.testing.assert_array_equal(ours.start_bits, theirs.start_bits)
    for a, b in zip(ours.qtables, theirs.qtables):
        np.testing.assert_array_equal(a, b)
    assert (ours.restart_interval, ours.mcus_x, ours.mcus_y, ours.gray,
            ours.sampling) == (theirs.restart_interval, theirs.mcus_x,
                               theirs.mcus_y, theirs.gray, theirs.sampling)
    assert tdd.min_code_bits(ours.specs) == jdd.min_code_len_from_key(
        theirs.tables_key)


def _plain_split_rst(entropy: bytes, n_chunks: int):
    """Plain model of split_rst_stream, in whole-array numpy: every FF
    is classified by the byte after it, independently of the others."""
    arr = np.frombuffer(entropy, np.uint8)
    if arr.size == 0:
        raise ValueError("empty entropy segment")
    ff = np.flatnonzero(arr == 0xFF)
    ff = ff[ff + 1 < arr.size]
    nxt = arr[ff + 1]
    rst_ff = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    stuff = ff[nxt == 0x00] + 1
    if rst_ff.size + 1 != n_chunks:
        raise ValueError(f"expected {n_chunks} restart intervals, found "
                         f"{rst_ff.size + 1}")
    keep = np.ones(arr.size, bool)
    keep[rst_ff] = False
    keep[rst_ff + 1] = False
    keep[stuff] = False
    data = arr[keep]
    # Interval k spans raw [rst_ff[k-1] + 2, rst_ff[k]) minus the
    # stuffed zeros inside that range.
    raw_starts = np.concatenate([[0], rst_ff + 2])
    raw_ends = np.concatenate([rst_ff, [arr.size]])
    lens = ((raw_ends - raw_starts)
            - (np.searchsorted(stuff, raw_ends)
               - np.searchsorted(stuff, raw_starts)))
    win = tdd.bucket_len(int(lens.max()))
    starts = np.concatenate([[0], np.cumsum(lens)])[:-1]
    return data, starts.astype(np.int32), win


def _rst_count(seg: bytes) -> int:
    arr = np.frombuffer(seg, np.uint8)
    nxt = arr[np.flatnonzero(arr[:-1] == 0xFF) + 1]
    return int(np.count_nonzero((nxt >= 0xD0) & (nxt <= 0xD7)))


def _assert_split_equal(seg: bytes):
    n_chunks = _rst_count(seg) + 1
    want = _plain_split_rst(seg, n_chunks)
    got = tdd.split_rst_stream(seg, n_chunks)
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("which", ["color", "gray", "one_bit",
                                   "golden_base", "golden_gm"])
def test_plain_split_model_matches_jax(which):
    """The plain model against the JAX package's parse: bytes, interval
    starts and window where the stream has restarts; where it has none
    (the goldens), the model's one interval holds the bytes that the
    JAX package's lengths-only scan destuffs, from offset 0."""
    data = _all_inputs()[which]
    hdr = tdd.parse_device_headers(headers.read_headers(data))
    theirs = jdd.parse_device_stream(data)
    n_mcus = hdr.mcus_x * hdr.mcus_y
    r = hdr.restart_interval
    dest, starts, win = _plain_split_rst(hdr.entropy,
                                         -(-n_mcus // r) if r else 1)
    np.testing.assert_array_equal(dest, theirs.dest)
    if r:
        np.testing.assert_array_equal(starts, theirs.starts_byte)
        assert win == theirs.win_len
    else:
        assert theirs.start_bits is not None
        assert starts.tolist() == [0] == theirs.starts_byte[:1].tolist()


SPLIT_EDGES = {
    "ff_ff_00": b"\x12\xff\xff\x00\x34",
    "ff_ff_rst": b"\x12\xff\xff\xd3\x34\x56",
    "trailing_ff": b"\x12\x34\xd0\xff",
    "opens_with_rst": b"\xff\xd0\x12\x34\xff\x00\x56",
    "rst_back_to_back": b"\x12\xff\xd1\xff\xd2\x34",
    "foreign_marker": b"\x12\xff\xc4\x34\xff\x00\x56\xff\xd5\x78",
    "stuffed_at_end": b"\x12\x34\xff\xd6\x56\xff\x00",
}


@pytest.mark.parametrize("name", sorted(SPLIT_EDGES))
def test_split_rst_edges_match_plain(name):
    _assert_split_equal(SPLIT_EDGES[name])


@pytest.mark.parametrize("token", [b"\xff", b"\xff\x00", b"\xff\xff",
                                   b"\xff\xd3", b"\xff\xc4",
                                   b"\xff\xff\xd0", b"\xff\xff\x00"])
def test_split_rst_token_at_every_offset(token):
    """One token at each offset of a 52-byte segment: across the
    16-byte steps of the vector pass and its hand-over to the walk."""
    base = bytes(range(1, 53))
    for p in range(len(base) + 1):
        _assert_split_equal(base[:p] + token + base[p:])


@pytest.mark.parametrize("seed", range(64))
def test_split_rst_random_match_plain(seed):
    """Random bytes with no FF, then FF, FF 00, FF Dx and FF FF put in
    at random places (so a lone FF may meet a 00 or a Dx of the data),
    from none to one in every few bytes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 0xFF, int(rng.integers(1, 4000)), np.uint8)
    tokens = [b"\xff", b"\xff\x00", b"\xff\xff"] + [
        bytes([0xFF, 0xD0 + k]) for k in range(8)]
    cuts = np.sort(rng.integers(0, base.size + 1,
                                int(rng.integers(0, base.size // 3 + 2))))
    parts, prev = [], 0
    for c in cuts:
        parts += [base[prev:c].tobytes(),
                  tokens[int(rng.integers(0, len(tokens)))]]
        prev = c
    _assert_split_equal(b"".join(parts) + base[prev:].tobytes())


@pytest.mark.parametrize("case", ["empty", "one_too_few", "one_too_many",
                                  "far_too_many"])
def test_split_rst_rejects_as_plain(case):
    seg = b"\x12\xff\xd0\x34\xff\x00\xff\xd1\x56"
    seg, n_chunks = {"empty": (b"", 1),
                     "one_too_few": (seg, 4),
                     "one_too_many": (seg, 2),
                     # 400 markers against a buffer of n_chunks + 1.
                     "far_too_many": (b"\x12\xff\xd7" * 400, 3)}[case]
    for split in (_plain_split_rst, tdd.split_rst_stream):
        with pytest.raises(ValueError):
            split(seg, n_chunks)


# ---------------------------------------------------------------------------
# B4, plain version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["color", "gray"])
def test_plain_b4_own_streams_match_jax_and_host(which):
    data = _own_streams()[which]
    ds = tdd.parse_device_stream(data)
    port = _port_grids([ds])
    _assert_grids(port, _jax_grids(_windows(ds), 4, ds.mcus_x, ds.mcus_y,
                                   ds.gray))
    _assert_grids(port, _host_grids(data))


@pytest.mark.parametrize("gray,units", [(False, 2), (False, 3), (True, 1),
                                        (True, 3)])
def test_plain_b4_garbage_matches_jax(gray, units):
    """Arbitrary bytes: lanes stop by their bit budget or block count
    exactly where the JAX loop stops them, and emit the same values
    (JAX's test_device_decode.py::test_garbage_chunks_identical_
    truncation, across its units-per-step settings)."""
    mx, my = (8, 1) if gray else (4, 2)
    specs = tdd.ANNEX_K_GRAY if gray else tdd.ANNEX_K_COLOR
    for seed in range(4):
        ch = np.random.default_rng(11 + seed).integers(0, 256, (4, 96),
                                                       np.uint8)
        frames = np.asarray([tdd.frame_row(0, ch.size, 96, 2, 0, 4, False,
                                           2)], np.int32)
        lanes = np.stack([np.arange(4) * 96, np.zeros(4)], 1).astype(
            np.int32)
        port = tdd.decode_rst_chunks(
            torch.from_numpy(ch.reshape(-1)), torch.from_numpy(frames),
            torch.from_numpy(lanes),
            torch.from_numpy(tdd.decode_tables(specs)[None]), gray,
            (2, 2), mx, my)
        _assert_grids(port, _jax_grids(ch, 2, mx, my, gray, units=units))


def test_plain_b4_one_bit_codes():
    """Tables with 1-bit codes (min_code_bits 1) from the stream's own
    DHTs: equal to JAX with its chains from the same DHTs, and to the
    host decoder."""
    data = _one_bit_jpeg()
    ds = tdd.parse_device_stream(data)
    assert tdd.min_code_bits(ds.specs) == 1
    port = _port_grids([ds])
    _assert_grids(port, _jax_grids(_windows(ds), 4, MX, MY, False,
                                   jdd.parse_device_stream(data).tables_key))
    _assert_grids(port, _host_grids(data))


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_plain_b4_goldens_dc_carry(name):
    """The reference's restart-less encodes: lanes synthesized by the
    host scan (start_bits), DC carried across them."""
    for k in (0, 1):
        data = _golden_part(name, k)
        ds = tdd.parse_device_stream(data)
        jds = jdd.parse_device_stream(data)
        assert ds.start_bits is not None
        port = _port_grids([ds])
        _assert_grids(port, _host_grids(data))
        _assert_grids(port, _jax_grids(
            _windows(ds), ds.restart_interval, ds.mcus_x, ds.mcus_y,
            ds.gray, jds.tables_key, ds.start_bits))


def test_b4_wrapper_runs_plain_on_cpu():
    ds = tdd.parse_device_stream(_own_streams()["gray"])
    before = tdd.decode_rst_chunks.launches
    ln = tdd.pack_streams([ds])
    args = [torch.from_numpy(a) for a in (ln.src, ln.frames, ln.lanes,
                                          ln.tables)]
    got = tdd.decode_rst_chunks(*args, True, (1, 1), ln.mcus_x, ln.mcus_y)
    want = tdd.decode_rst_chunks_plain(*args, True, (1, 1), ln.mcus_x,
                                       ln.mcus_y)
    assert torch.equal(got[0], want[0])
    assert tdd.decode_rst_chunks.launches == before


@pytest.mark.parametrize("which", ["color", "gray"])
def test_padded_src_decodes_the_same(which):
    """pack_streams ends src in zeros up to a multiple of 16 and 16 more
    (the kernels' aligned loads stay inside it); the descriptors still
    bound each lane, so the plain decode equals JAX's grids."""
    ds = tdd.parse_device_stream(_own_streams()[which])
    ln = tdd.pack_streams([ds])
    assert ln.src.size % 16 == 0 and ln.src.size - ds.dest.size >= 16
    np.testing.assert_array_equal(ln.src[:ds.dest.size], ds.dest)
    assert not ln.src[ds.dest.size:].any()
    assert int(ln.frames[0, tdd.F_LEN]) == ds.dest.size
    _assert_grids(_port_grids([ds]), _jax_grids(
        _windows(ds), 4, ds.mcus_x, ds.mcus_y, ds.gray))


# ---------------------------------------------------------------------------
# The kernels' fast lookup (huff_decode.cu stage_tables).
# ---------------------------------------------------------------------------

def _random_dht(rng, symbols, incomplete: bool):
    """(bits, vals) of a random DHT over `symbols` whose longest code is
    16 bits: lengths drawn within the Kraft budget (leaving the all-ones
    code unused), the last symbol at 16 bits; an incomplete one stops
    with code space left."""
    room = (1 << 16) - 1
    if incomplete:
        room -= 1 << 12
    lengths = []
    for i, _ in enumerate(symbols):
        if i == len(symbols) - 1:
            lengths.append(16)
            break
        length = int(rng.integers(1 if i == 0 else 2, 17))
        while (1 << (16 - length)) > room - (len(symbols) - i - 1):
            length += 1
        lengths.append(length)
        room -= 1 << (16 - length)
    order = np.argsort(lengths, kind="stable")
    bits = [int(np.sum(np.asarray(lengths) == k)) for k in range(1, 17)]
    return bits, [int(symbols[i]) for i in order]


def _table_sets():
    sets = {"annex_k_color": tdd.ANNEX_K_COLOR,
            "annex_k_gray": tdd.ANNEX_K_GRAY,
            "one_bit": (ONE_BIT_DC, ONE_BIT_AC, ONE_BIT_DC, ONE_BIT_AC)}
    ac_syms = np.asarray(tables.AC_LUMA_VALS)
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        sets[f"random_{seed}"] = tuple(
            _random_dht(rng, rng.permutation(syms)[:n], seed % 2 == 1)
            for syms, n in ((np.arange(12), 12), (ac_syms, 162),
                            (np.arange(12), 6), (ac_syms, 40)))
    return sets


@pytest.mark.parametrize("name", list(_table_sets()))
def test_fast_lookup_equals_search(name):
    """For every one of the 65,536 peeks of each table, the fast entry
    (or the binary search where it is marked) is the entry the select
    chain gives (_lut): the construction is exact for any DHT."""
    tabs = tdd.decode_tables(_table_sets()[name])
    fast = tdd.fast_lookup_table(tabs)
    lut = tdd._lut(torch.from_numpy(tabs)).numpy()
    peeks = np.arange(65536, dtype=np.int64)
    marked = 0
    for t in range(4):
        f = fast[t][peeks >> (16 - tdd.FAST_BITS)].astype(np.int64)
        slow = tabs[t, 257 + tdd._search(tabs[t], peeks)]
        got = np.where(f == tdd.FAST_SEARCH, slow, f)
        np.testing.assert_array_equal(got, lut[t])
        marked += int((fast[t] == tdd.FAST_SEARCH).sum())
    assert 0 < marked < 4 * 512 or name == "one_bit"


# ---------------------------------------------------------------------------
# Decode routes.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _encoded(seed=0, quality=95):
    from test_torch_jpegr import synth_p010
    ys, uvs = zip(*(synth_p010(H, W, seed=seed + i) for i in range(2)))
    return batched.batched_encode_api0(
        np.stack(ys), np.stack(uvs), "bt2100", "hlg", quality,
        device="cpu", return_handoff=True)


@pytest.mark.parametrize("fmt", ["HDR_LINEAR", "HDR_HLG", "HDR_PQ"])
def test_jpegr_decode_device_route_equals_host_route(fmt):
    blob = _encoded()[0][0]
    calls = codec.entropy_decode.calls
    got = JpegR("cpu").decode(blob, OutputFormat[fmt]).image.planes["rgba"]
    assert codec.entropy_decode.calls == calls   # no host Huffman ran
    host = batched.decode_device_stage(
        [batched.decode_host_huffman(mux.read_primary_and_gainmap(blob))],
        OutputFormat[fmt].value, float("inf"), "cpu")[0].numpy()
    assert codec.entropy_decode.calls == calls + 2
    np.testing.assert_array_equal(got.view(host.dtype), host)


@pytest.mark.parametrize("fmt", ["hdr_linear", "hdr_hlg"])
def test_handoff_equals_blob_decode(fmt):
    blobs, handoff = _encoded()
    got = batched.batched_decode_from_handoff(handoff, fmt)
    want = batched.batched_decode(blobs, fmt, device="cpu")
    assert torch.equal(got, want)


def test_mixed_table_batch_decodes_in_one_batch():
    """Frames that differ in quant tables (quality 95 vs 60) and in
    Huffman tables (Annex K vs 1-bit codes) share one device-route
    batch; each frame equals its own decode."""
    blob_a = _encoded()[0][0]
    _, gm = mux.extract_primary_and_gainmap(blob_a)
    blob_b = mux.append_gainmap(_one_bit_jpeg(quality=60), gm,
                                batched.api0_metadata("hlg"))
    frames = batched.decode_host_stage([blob_a, blob_b])
    assert all(f.streams is not None for f in frames)
    both = batched.batched_decode([blob_a, blob_b], "hdr_hlg", device="cpu")
    for i, b in enumerate((blob_a, blob_b)):
        assert torch.equal(both[i], batched.batched_decode(
            [b], "hdr_hlg", device="cpu")[0])


def test_non_420_base_takes_host_route_and_raises():
    """A 4:4:4 base is routed to the host from its headers alone, which
    raises the reference's error."""
    nb = (W // 8) * (H // 8)
    blocks = np.zeros((nb * 3, 64), np.int16)
    scan = codec.entropy_encode(
        blocks, np.tile(np.arange(3, dtype=np.uint8), nb), [0, 1, 1],
        [0, 1, 1], [(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS),
                    (tables.DC_CHROMA_BITS, tables.DC_CHROMA_VALS)],
        [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS),
         (tables.AC_CHROMA_BITS, tables.AC_CHROMA_VALS)], 0, 3)
    base = codec.ycbcr_jpeg_headers(W, H, 90, (1, 1)) + scan + b"\xff\xd9"
    _, gm = mux.extract_primary_and_gainmap(_encoded()[0][0])
    blob = mux.append_gainmap(base, gm, batched.api0_metadata("hlg"))
    assert batched.parse_device_route(
        mux.read_primary_and_gainmap(blob)) is None
    calls = codec.entropy_decode.calls
    with pytest.raises(UhdrError, match="not YCbCr 4:2:0"):
        JpegR("cpu").decode(blob, OutputFormat.HDR_HLG)
    assert codec.entropy_decode.calls == calls + 1
