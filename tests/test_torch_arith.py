"""The port's arithmetic-coded JPEG codec (libultrahdr_dev_tpu_torch/jpeg/
arith.py over jpeg/arith.cpp, and its SOF9 / SOF10 routes in
jpeg/codec.py) on the CPU, against the JAX package, the port's own plain
specification and the system libjpeg.

Mirrors tests/test_arith.py: the QM coder's round trips (on the plain
specification, arith.Decoder / arith.Encoder), the native scan codec's
round trips, the libjpeg oracle cases (tools/arith_oracle.c, built with
gcc -ljpeg; skipped where either is absent), the codec-level SOF9 /
SOF10 routing, the fuzz and bad-DAC cases, and the native copy against
the plain specification bit for bit (the ``*_plain`` scan loops in
place of the native ones). Bars of the port's own cases: encode_jpeg's
arithmetic bytes identical to the JAX package's (gray and 4:2:0, restart
intervals 0 and 2, and one 4000x3000 frame); coefficient grids of SOF9
and SOF10 files identical to the JAX package's at 1 scan thread and at
the default count; a JPEG/R with an arithmetic primary decoded through
the stable API within 1 ten-bit code of the JAX package's host route
(SDR within 1); and without the native library every arithmetic entry
point raises, the plain specification never running in its place."""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

from libultrahdr_dev_tpu.container import mux as jmux
from libultrahdr_dev_tpu.jpeg import codec as jcodec
from libultrahdr_dev_tpu_torch import (ColorTransfer, JpegR, OutputFormat,
                                       PixelFormat, UhdrDecoder, UhdrError)
from libultrahdr_dev_tpu_torch.container import mux as tmux
from libultrahdr_dev_tpu_torch.jpeg import arith, codec, native
from libultrahdr_dev_tpu_torch.types import GainMapMetadata

from test_torch_jpegr import channel_diff, jax_host_decode
from test_torch_sdr import jax_host_sdr, rgba_diff
import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """tools/arith_oracle.c built with the system libjpeg, or a skip."""
    if not shutil.which("gcc"):
        pytest.skip("no gcc/libjpeg for oracle")
    exe = str(tmp_path_factory.mktemp("oracle") / "arith_oracle")
    r = subprocess.run(["gcc", "-O2", os.path.join(REPO, "tools",
                                                    "arith_oracle.c"),
                        "-ljpeg", "-o", exe], capture_output=True)
    if r.returncode != 0:
        pytest.skip("no gcc/libjpeg for oracle")
    return exe


def _oracle_enc(exe, raw, w, h, nc, q, prog, rst, tmp_path):
    rp, jp = str(tmp_path / "in.raw"), str(tmp_path / "o.jpg")
    raw.tofile(rp)
    subprocess.run([exe, "enc", rp, str(w), str(h), str(nc), str(q),
                    str(prog), str(rst), jp], check=True)
    return open(jp, "rb").read()


def _oracle_coefs(exe, blob, tmp_path):
    jp, cf = str(tmp_path / "c.jpg"), str(tmp_path / "c.coef")
    open(jp, "wb").write(blob)
    subprocess.run([exe, "coef", jp, cf], check=True)
    b = open(cf, "rb").read()
    nc, = struct.unpack_from("<i", b, 0)
    off, out = 4, []
    for _ in range(nc):
        bw, bh = struct.unpack_from("<ii", b, off)
        off += 8
        out.append(np.frombuffer(b, "<i2", bh * bw * 64, off).reshape(
            bh, bw, 64))
        off += bh * bw * 128
    return out


def _synth_gray(w, h, seed=1):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1)).astype(
        np.float32)
    img = np.kron(small, np.ones((8, 8), np.float32))[:h, :w]
    return ((img + np.roll(img, 3, 0) + np.roll(img, 3, 1)) / 3).astype(
        np.uint8)


def _rgb(w, h, seed=2):
    g = _synth_gray(w, h, seed=seed)
    return np.stack([g, np.roll(g, 5, 1), np.roll(g, 9, 0)], -1)


def _rand_blocks(nblocks, seed=0, dcmax=300, acmax=255):
    rng = np.random.default_rng(seed)
    blocks = np.zeros((nblocks, 64), np.int16)
    blocks[:, 0] = rng.integers(-dcmax, dcmax + 1, nblocks)
    for i in range(nblocks):
        pos = rng.integers(1, 64, rng.integers(0, 24))
        blocks[i, pos] = rng.integers(-acmax, acmax + 1, pos.size)
    return blocks


def _planes(seed=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    return {"y": _synth_gray(w, h, seed),
            "u": rng.integers(96, 160, (h // 2, w // 2)).astype(np.uint8),
            "v": rng.integers(96, 160, (h // 2, w // 2)).astype(np.uint8)}


def _grids(res):
    return [c[0] for c in res.comps]


def _assert_grids_equal(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert ga.shape == gb.shape
        np.testing.assert_array_equal(ga, gb)


class TestQmCoder:
    """The plain specification's QM coder (T.81 Annex D)."""

    def test_raw_bit_roundtrip(self):
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, 4000).tolist()
        bits += (rng.random(4000) < 0.95).astype(int).tolist()
        enc = arith.Encoder()
        st = bytearray(1)
        for b in bits:
            enc.encode(st, 0, int(b))
        blob = enc.flush()
        dec = arith.Decoder(blob)
        st2 = bytearray(1)
        assert [dec.decode(st2, 0) for _ in bits] == bits
        # adaptive coding must beat 1 bit/symbol on the biased half
        assert len(blob) < len(bits) // 8

    def test_fixed_state_is_equiprobable(self):
        # state 113 never adapts (T.81: used for AC signs)
        qe, nmps, nlps, sw = arith.QE_TABLE[arith.FIXED_STATE]
        assert (nmps, nlps, sw) == (113, 113, 0)
        assert qe == 0x5A1D

    def test_stuffing_roundtrip(self):
        enc = arith.Encoder()
        st = bytearray(1)
        bits = ([1] * 2000 + [0]) * 5
        for b in bits:
            enc.encode(st, 0, b)
        blob = enc.flush()
        dec = arith.Decoder(blob)
        st2 = bytearray(1)
        assert [dec.decode(st2, 0) for _ in bits] == bits


class TestSequentialScan:
    """The native sequential scan codec (jpeg/arith.cpp)."""

    @pytest.mark.parametrize("restart", [0, 7, 1])
    def test_roundtrip_interleaved(self, restart):
        mcu_blocks, n_mcus = 6, 25
        comp_ids = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), n_mcus)
        blocks = _rand_blocks(n_mcus * mcu_blocks)
        args = ([0, 1, 1], [0, 1, 1], {0: (0, 1), 1: (0, 1)},
                {0: 5, 1: 5}, restart, mcu_blocks)
        data = arith.encode_seq_scan(blocks, comp_ids, *args)
        out = np.zeros_like(blocks)
        arith.decode_seq_scan(data, out, comp_ids, *args)
        np.testing.assert_array_equal(blocks, out)

    def test_extreme_coefficients(self):
        blocks = np.zeros((4, 64), np.int16)
        blocks[0, 0], blocks[1, 0] = 2047, -2047
        blocks[2, 1], blocks[3, 63] = 1023, -1023
        cid = np.zeros(4, np.uint8)
        d = arith.encode_seq_scan(blocks, cid, [0], [0], {0: (0, 1)},
                                  {0: 5}, 0, 1)
        o = np.zeros_like(blocks)
        arith.decode_seq_scan(d, o, cid, [0], [0], {0: (0, 1)}, {0: 5},
                              0, 1)
        np.testing.assert_array_equal(blocks, o)

    def test_nondefault_conditioning_roundtrip(self):
        blocks = _rand_blocks(24, seed=3)
        cid = np.zeros(24, np.uint8)
        for cond in [(1, 3), (0, 0), (4, 8)]:
            for kx in (1, 30, 63):
                d = arith.encode_seq_scan(blocks, cid, [0], [0], {0: cond},
                                          {0: kx}, 0, 1)
                o = np.zeros_like(blocks)
                arith.decode_seq_scan(d, o, cid, [0], [0], {0: cond},
                                      {0: kx}, 0, 1)
                np.testing.assert_array_equal(blocks, o)

    def test_truncated_stream_raises_or_garbage(self):
        blocks = _rand_blocks(16, seed=4)
        cid = np.zeros(16, np.uint8)
        d = arith.encode_seq_scan(blocks, cid, [0], [0], {0: (0, 1)},
                                  {0: 5}, 0, 1)
        for cut in (1, len(d) // 2, len(d) - 2):
            o = np.zeros_like(blocks)
            try:
                arith.decode_seq_scan(d[:cut], o, cid, [0], [0],
                                      {0: (0, 1)}, {0: 5}, 0, 1)
            except arith.ArithError:
                pass


class TestLibjpegConformance:
    """The native codec against the system libjpeg, bit for bit."""

    @pytest.mark.parametrize("rst", [0, 4])
    def test_sequential_gray_decode_matches(self, rst, oracle, tmp_path):
        w, h = 64, 48
        blob = _oracle_enc(oracle, _synth_gray(w, h), w, h, 1, 90, 0, rst,
                           tmp_path)
        want = _oracle_coefs(oracle, blob, tmp_path)
        got = codec.decode_jpeg_coefs(blob)
        _assert_grids_equal([g[:want[0].shape[0], :want[0].shape[1]]
                             for g in _grids(got)], want)

    def test_progressive_gray_decode_matches(self, oracle, tmp_path):
        w, h = 64, 48
        blob = _oracle_enc(oracle, _synth_gray(w, h, seed=7), w, h, 1, 85,
                           1, 0, tmp_path)
        assert blob.count(b"\xff\xda") >= 4   # successive approximation
        want = _oracle_coefs(oracle, blob, tmp_path)
        _assert_grids_equal(_grids(codec.decode_jpeg_coefs(blob)), want)

    @pytest.mark.parametrize("rst", [0, 3])
    def test_libjpeg_decodes_our_encode(self, rst, oracle, tmp_path):
        bh, bw = 6, 8
        blocks = _rand_blocks(bh * bw, seed=5, dcmax=200, acmax=100)
        ent = arith.encode_seq_scan(blocks, np.zeros(bh * bw, np.uint8),
                                    [0], [0], {0: (0, 1)}, {0: 5}, rst, 1)

        def mk(m, p):
            return bytes((0xFF, m)) + (len(p) + 2).to_bytes(2, "big") + p

        w, h = bw * 8, bh * 8
        out = b"\xff\xd8"
        out += mk(0xDB, bytes([0]) + bytes(np.ones(64, np.uint8)))
        out += mk(0xC9, bytes([8]) + h.to_bytes(2, "big")
                  + w.to_bytes(2, "big") + bytes([1, 1, 0x11, 0]))
        out += mk(0xCC, bytes([0x00, 0x10, 0x10, 5]))
        if rst:
            out += mk(0xDD, rst.to_bytes(2, "big"))
        out += mk(0xDA, bytes([1, 1, 0x00, 0, 63, 0]))
        out += ent + b"\xff\xd9"
        got = _oracle_coefs(oracle, out, tmp_path)[0].reshape(-1, 64)
        np.testing.assert_array_equal(got, blocks)

    def test_sequential_color_420_decode_matches(self, oracle, tmp_path):
        w, h = 80, 64
        rng = np.random.default_rng(11)
        g = _synth_gray(w, h, seed=2)
        rgb = np.stack([g, np.roll(g, 5, 1),
                        rng.integers(0, 256, (h, w)).astype(np.uint8)], -1)
        blob = _oracle_enc(oracle, rgb, w, h, 3, 90, 0, 0, tmp_path)
        want = _oracle_coefs(oracle, blob, tmp_path)
        got = _grids(codec.decode_jpeg_coefs(blob))
        _assert_grids_equal([g[:c.shape[0], :c.shape[1]]
                             for g, c in zip(got, want)], want)


class TestCodecIntegration:
    """decode_jpeg_coefs / encode_jpeg level: SOF9/SOF10 routing, DAC
    parsing and the arithmetic encode option, on the CPU."""

    @pytest.mark.parametrize("rst", [0, 2])
    def test_arith_encode_matches_huffman_coefs(self, rst):
        planes = _planes()
        a = codec.encode_jpeg(planes, 90, restart_interval=rst,
                              arithmetic=True, device="cpu")
        hj = codec.encode_jpeg(planes, 90, restart_interval=rst,
                               device="cpu")
        _assert_grids_equal(_grids(codec.decode_jpeg_coefs(a)),
                            _grids(codec.decode_jpeg_coefs(hj)))
        assert len(a) < len(hj)

    def test_arith_encode_gray(self):
        y = _synth_gray(64, 48, seed=9)
        a = codec.encode_jpeg({"y": y}, 85, arithmetic=True, device="cpu")
        hj = codec.encode_jpeg({"y": y}, 85, device="cpu")
        _assert_grids_equal(_grids(codec.decode_jpeg_coefs(a)),
                            _grids(codec.decode_jpeg_coefs(hj)))

    def test_pil_decodes_our_arith_jpeg(self):
        import io

        Image = pytest.importorskip("PIL.Image")
        blob = codec.encode_jpeg(_planes(), 90, arithmetic=True,
                                 device="cpu")
        im = Image.open(io.BytesIO(blob))
        im.load()
        assert im.size == (64, 48)

    def test_full_decode_pixels_equal_huffman(self):
        planes = _planes(seed=4)
        a = codec.decode_jpeg(codec.encode_jpeg(
            planes, 90, arithmetic=True, device="cpu"), "cpu")
        hj = codec.decode_jpeg(codec.encode_jpeg(planes, 90, device="cpu"),
                               "cpu")
        assert a.sampling == hj.sampling
        for pa, ph in zip(a.planes, hj.planes):
            assert bool((pa == ph).all())

    def test_jpegr_decodes_arith_base(self):
        """API-4 mux with an arithmetic-coded base JPEG decodes through
        the whole JPEG/R path, bitwise the decode of the same JPEG/R with
        the Huffman-coded base (same grids, same B5 and B6)."""
        planes = _planes(seed=6)
        gmap = codec.encode_jpeg({"y": _synth_gray(16, 12, seed=8)}, 85,
                                 device="cpu")
        md = GainMapMetadata(max_content_boost=4.0, min_content_boost=1.0,
                             hdr_capacity_max=4.0)
        jr = JpegR("cpu")
        outs = [jr.decode(jr.encode_api4(codec.encode_jpeg(
            planes, 92, arithmetic=arithmetic, device="cpu"), gmap, md))
            for arithmetic in (True, False)]
        assert (outs[0].width, outs[0].height) == (64, 48)
        np.testing.assert_array_equal(outs[0].image.planes["rgba"],
                                      outs[1].image.planes["rgba"])

    def test_oracle_decodes_codec_arith_output(self, oracle, tmp_path):
        blob = codec.encode_jpeg(_planes(seed=5), 88, restart_interval=3,
                                 arithmetic=True, device="cpu")
        want = _oracle_coefs(oracle, blob, tmp_path)
        got = _grids(codec.decode_jpeg_coefs(blob))
        _assert_grids_equal([g[:c.shape[0], :c.shape[1]]
                             for g, c in zip(got, want)], want)

    @pytest.mark.parametrize("prog,rst", [(0, 0), (0, 5), (1, 0), (1, 3)])
    def test_decode_jpeg_coefs_color_conformance(self, prog, rst, oracle,
                                                 tmp_path):
        w, h = 80, 64
        blob = _oracle_enc(oracle, _rgb(w, h), w, h, 3, 90, prog, rst,
                           tmp_path)
        want = _oracle_coefs(oracle, blob, tmp_path)
        got = _grids(codec.decode_jpeg_coefs(blob))
        _assert_grids_equal([g[:c.shape[0], :c.shape[1]]
                             for g, c in zip(got, want)], want)


class TestArithFuzz:
    def test_mutated_streams_never_crash(self):
        rng = np.random.default_rng(17)
        blob = bytearray(codec.encode_jpeg({"y": _synth_gray(48, 32, 13)},
                                           80, arithmetic=True,
                                           device="cpu"))
        for _ in range(120):
            mut = bytearray(blob)
            for _ in range(rng.integers(1, 6)):
                mut[rng.integers(2, len(mut))] = rng.integers(0, 256)
            try:
                codec.decode_jpeg_coefs(bytes(mut))
            except UhdrError:
                pass

    def test_truncations_never_crash(self):
        blob = codec.encode_jpeg({"y": _synth_gray(48, 32, seed=14)}, 80,
                                 restart_interval=2, arithmetic=True,
                                 device="cpu")
        for cut in range(2, len(blob), 37):
            try:
                codec.decode_jpeg_coefs(blob[:cut])
            except UhdrError:
                pass

    def test_bad_dac_rejected(self):
        blob = bytearray(codec.encode_jpeg({"y": _synth_gray(32, 32, 15)},
                                           80, arithmetic=True,
                                           device="cpu"))
        i = bytes(blob).find(b"\xff\xcc")
        assert i > 0
        for payload in (b"\x50\x10", b"\x00\x01", b"\x10\x00", b"\x10\x40"):
            mut = bytearray(blob)
            mut[i + 4: i + 6] = payload[:2]
            with pytest.raises(UhdrError, match="CODEC_ERROR"):
                codec.decode_jpeg_coefs(bytes(mut))
            with pytest.raises(Exception):
                jcodec.decode_jpeg_coefs(bytes(mut))


def _plain_only(monkeypatch):
    """The plain specification's scan loops in place of the native
    entry points (as the JAX tests mask the native library)."""
    for name in ("decode_seq_scan", "encode_seq_scan", "prog_dc_first",
                 "prog_dc_refine", "prog_ac_first", "prog_ac_refine"):
        monkeypatch.setattr(arith, name, getattr(arith, name + "_plain"))


class TestNativePlainParity:
    """The native copy (jpeg/arith.cpp) and the plain specification
    agree bit for bit: same encoded streams, same decoded coefficients,
    same verdict on corrupt input."""

    @pytest.mark.parametrize("restart", [0, 2])
    def test_seq_encode_bitexact(self, restart):
        blocks = _rand_blocks(24, seed=21)
        comp_ids = np.tile(np.array([0, 0, 1, 2], np.uint8), 6)
        args = (blocks, comp_ids, [0, 1, 1], [0, 1, 1],
                {0: (0, 1), 1: (1, 2)}, {0: 5, 1: 10}, restart, 4)
        assert arith.encode_seq_scan(*args) == \
            arith.encode_seq_scan_plain(*args)

    @pytest.mark.parametrize("restart", [0, 2])
    def test_seq_decode_bitexact(self, restart):
        blocks = _rand_blocks(24, seed=22)
        comp_ids = np.tile(np.array([0, 0, 1, 2], np.uint8), 6)
        cond = ([0, 1, 1], [0, 1, 1], {0: (0, 1), 1: (2, 3)},
                {0: 5, 1: 63}, restart, 4)
        bits = arith.encode_seq_scan(blocks, comp_ids, *cond)
        out_n, out_p = np.zeros_like(blocks), np.zeros_like(blocks)
        arith.decode_seq_scan(bits, out_n, comp_ids, *cond)
        arith.decode_seq_scan_plain(bits, out_p, comp_ids, *cond)
        np.testing.assert_array_equal(out_n, blocks)
        np.testing.assert_array_equal(out_n, out_p)

    @pytest.mark.parametrize("prog,rst", [(0, 2), (1, 0), (1, 3)])
    def test_file_decode_bitexact(self, prog, rst, oracle, tmp_path,
                                  monkeypatch):
        """A whole SOF9 / SOF10 file through decode_jpeg_coefs, native
        against the plain loops (every progressive scan kind)."""
        w, h = 48, 40
        blob = _oracle_enc(oracle, _rgb(w, h, seed=23), w, h, 3, 80, prog,
                           rst, tmp_path)
        native_grids = _grids(codec.decode_jpeg_coefs(blob))
        _plain_only(monkeypatch)
        _assert_grids_equal(native_grids,
                            _grids(codec.decode_jpeg_coefs(blob)))

    def test_codec_file_decode_bitexact(self, monkeypatch):
        y = _synth_gray(48, 40, seed=23)
        blob = codec.encode_jpeg({"y": y}, 80, arithmetic=True,
                                 device="cpu")
        ref = _grids(codec.decode_jpeg_coefs(blob))
        _plain_only(monkeypatch)
        _assert_grids_equal(ref, _grids(codec.decode_jpeg_coefs(blob)))
        assert codec.encode_jpeg({"y": y}, 80, arithmetic=True,
                                 device="cpu") == blob

    def test_corrupt_stream_same_verdict(self):
        blocks = _rand_blocks(16, seed=24)
        comp_ids = np.zeros(16, np.uint8)
        cond = ([0], [0], {0: arith.DEFAULT_DC_COND},
                {0: arith.DEFAULT_AC_COND}, 0, 1)
        bits = arith.encode_seq_scan(blocks, comp_ids, *cond)
        rng = np.random.default_rng(25)

        def run(fn, mut):
            out = np.zeros_like(blocks)
            try:
                fn(mut, out, comp_ids, *cond)
                return ("ok", out.tobytes())
            except arith.ArithError:
                return ("err", None)

        for trial in range(40):
            mut = bytearray(bits)
            for _ in range(rng.integers(1, 5)):
                mut[rng.integers(0, len(mut))] = rng.integers(0, 256)
            mut = bytes(mut)
            assert run(arith.decode_seq_scan, mut) == \
                run(arith.decode_seq_scan_plain, mut), f"trial {trial}"


# ---------------------------------------------------------------------------
# The port against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gray", "420"])
@pytest.mark.parametrize("rst", [0, 2])
def test_arith_encode_bytes_identical_to_jax(kind, rst):
    planes = _planes(seed=31, h=37, w=58)
    planes["u"], planes["v"] = planes["u"][:18, :29], planes["v"][:18, :29]
    if kind == "gray":
        planes = {"y": planes["y"]}
    want = jcodec.encode_jpeg(planes, 87, restart_interval=rst,
                              arithmetic=True)
    got = codec.encode_jpeg(planes, 87, restart_interval=rst,
                            arithmetic=True, device="cpu")
    assert got == want
    assert got[got.index(b"\xff\xc9"):].startswith(b"\xff\xc9")


def test_arith_encode_4000x3000_identical_to_jax():
    """One camera frame: bytes and grids identical to the JAX package's,
    and the grids equal to the Huffman-coded file's."""
    rng = np.random.default_rng(41)
    h, w = 3000, 4000

    def plane(ph, pw, lo, hi):
        small = rng.integers(lo, hi, (ph // 32 + 1, pw // 32 + 1))
        return np.kron(small, np.ones((32, 32), np.int64))[:ph, :pw].astype(
            np.uint8)

    planes = {"y": plane(h, w, 0, 256), "u": plane(h // 2, w // 2, 96, 160),
              "v": plane(h // 2, w // 2, 96, 160)}
    got = codec.encode_jpeg(planes, 90, restart_interval=0,
                            arithmetic=True, device="cpu")
    assert got == jcodec.encode_jpeg(planes, 90, arithmetic=True)
    ours = _grids(codec.decode_jpeg_coefs(got))
    _assert_grids_equal(ours, _grids(jcodec.decode_jpeg_coefs(got)))
    huff = codec.encode_jpeg(planes, 90, device="cpu")
    _assert_grids_equal(ours, _grids(codec.decode_jpeg_coefs(huff)))


@pytest.mark.parametrize("threads", ["1", None])
@pytest.mark.parametrize("prog,rst", [(0, 0), (0, 4), (1, 0), (1, 2)])
def test_sof9_sof10_grids_identical_to_jax(prog, rst, threads, oracle,
                                           tmp_path, monkeypatch):
    if threads is None:
        monkeypatch.delenv("UHDR_SCAN_THREADS", raising=False)
    else:
        monkeypatch.setenv("UHDR_SCAN_THREADS", threads)
    w, h = 72, 56
    blob = _oracle_enc(oracle, _rgb(w, h, seed=prog + rst), w, h, 3, 88,
                       prog, rst, tmp_path)
    assert (b"\xff\xca" if prog else b"\xff\xc9") in blob
    _assert_grids_equal(_grids(codec.decode_jpeg_coefs(blob)),
                        _grids(jcodec.decode_jpeg_coefs(blob)))
    planes = codec.decode_jpeg(blob, "cpu").planes
    want = jcodec.decode_jpeg(blob).planes
    for a, b in zip(planes, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sof9_stream_refused_by_device_decoder():
    """An arithmetic stream never reaches B4: parse_device_stream
    returns None for SOF9 (its component list stays empty), so
    decode_jpeg takes the host route."""
    from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd

    planes = _planes(seed=32)
    blob = codec.encode_jpeg(planes, 90, arithmetic=True, device="cpu")
    assert dd.parse_device_stream(blob) is None
    assert dd.parse_device_stream(codec.encode_jpeg(planes, 90,
                                                    device="cpu")) is not None
    calls = codec.entropy_decode.calls
    launches = dd.decode_stream_device.launches
    codec.decode_jpeg(blob, "cpu")
    assert codec.entropy_decode.calls == calls
    assert dd.decode_stream_device.launches == launches


def _arith_jpegr():
    """(port JPEG/R with an arithmetic primary, its JAX twin's bytes)."""
    from libultrahdr_dev_tpu import jpegr as jjpegr
    from libultrahdr_dev_tpu.types import GainMapMetadata as JMeta

    from test_torch_jpegr import synth_p010

    h, w = 48, 64
    y10, _ = synth_p010(h, w, seed=5)
    planes = {"y": (y10 >> 8).astype(np.uint8),
              "u": np.full((h // 2, w // 2), 120, np.uint8),
              "v": np.full((h // 2, w // 2), 136, np.uint8)}
    base = codec.encode_jpeg(planes, 92, arithmetic=True, device="cpu")
    gmap = codec.encode_jpeg({"y": _synth_gray(w // 4, h // 4, seed=8)}, 85,
                             device="cpu")
    kw = dict(max_content_boost=4.0, min_content_boost=1.0,
              hdr_capacity_max=4.0)
    tb = JpegR("cpu").encode_api4(base, gmap, GainMapMetadata(**kw))
    jb = jjpegr.JpegR().encode_api4(base, gmap, JMeta(**kw))
    return tb, jb


def test_jpegr_arith_primary_through_api_as_jax():
    """A JPEG/R whose primary is arithmetic-coded, decoded through the
    stable API (UhdrDecoder) to HLG within 1 ten-bit code of the JAX
    package's host route and to SDR within 1 of its SDR decode."""
    tb, jb = _arith_jpegr()
    assert tb == jb
    assert tmux.extract_primary_and_gainmap(tb)[0].find(b"\xff\xc9") > 0
    dec = UhdrDecoder("cpu")
    dec.set_image(tb)
    dec.set_out_img_format(PixelFormat.RGBA1010102)
    dec.set_out_color_transfer(ColorTransfer.HLG)
    got = dec.decode().planes["rgba"]
    want = jax_host_decode(tb, "hdr_hlg")[0]
    d = channel_diff(got, want, "hdr_hlg")
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
    sdr = JpegR("cpu").decode(tb, OutputFormat.SDR).image.planes["rgba"]
    d = rgba_diff(sdr, jax_host_sdr(jb))
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
    assert jmux.extract_primary_and_gainmap(jb)[0] == \
        tmux.extract_primary_and_gainmap(tb)[0]


def test_missing_native_library_raises(monkeypatch):
    """No fallback: when jpeg/arith.cpp cannot be loaded, the arithmetic
    encode and decode raise, and the plain specification never runs."""
    blob = codec.encode_jpeg(_planes(seed=33), 90, arithmetic=True,
                             device="cpu")

    def unavailable():
        raise RuntimeError("building arith.cpp failed")

    calls = []
    monkeypatch.setattr(arith, "get_arith", unavailable)
    for name in ("decode_seq_scan_plain", "encode_seq_scan_plain"):
        real = getattr(arith, name)
        monkeypatch.setattr(arith, name,
                            lambda *a, _r=real, _n=name: calls.append(_n)
                            or _r(*a))
    with pytest.raises(RuntimeError, match="arith.cpp"):
        codec.encode_jpeg(_planes(seed=33), 90, arithmetic=True,
                          device="cpu")
    with pytest.raises(RuntimeError, match="arith.cpp"):
        codec.decode_jpeg_coefs(blob)
    assert calls == []
    assert native.get_arith() is not None
