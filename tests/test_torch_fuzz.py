"""Property / fuzz tests of the port on the CPU, mirroring
tests/test_fuzz.py (the reference's two libFuzzer targets: arbitrary
bytes must never crash probe / decode; random valid dims, gamut, TF and
quality must encode and decode) with device="cpu", as seeded
deterministic sweeps. Every input raises UhdrError or returns. Where the
JAX tests read the reference's sample_heicr.heic (not mounted), the
mutations here start from an AVIF_R the port writes; where they compare
the JAX package's native and pure-Python Huffman decoders, the port's
native decoder is held against the JAX package's Python one."""

import numpy as np
import pytest

from libultrahdr_dev_tpu_torch.container import icc, jfif, mux, xmp
from libultrahdr_dev_tpu_torch.heifr import HeifR, heif_available
from libultrahdr_dev_tpu_torch.jpeg import codec
from libultrahdr_dev_tpu_torch.jpegr import JpegR
from libultrahdr_dev_tpu_torch.types import (ColorGamut, ColorTransfer,
                                             GainMapMetadata, OutputFormat,
                                             PixelFormat, RawImage,
                                             UhdrError)

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)


def _p010(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return RawImage(
        fmt=PixelFormat.P010, width=w, height=h, gamut=ColorGamut.BT2100,
        transfer=ColorTransfer.HLG,
        planes={"y": (rng.integers(64, 940, (h, w)).astype(np.uint16)) << 6,
                "uv": (rng.integers(64, 960, (h // 2, w)).astype(
                    np.uint16)) << 6})


class TestDecodeFuzz:
    """Arbitrary bytes -> parser/probe/decode must raise UhdrError (or
    return cleanly), never crash or hang."""

    def _poke(self, data: bytes):
        assert mux.is_uhdr_image(data) in (True, False)
        jr = JpegR("cpu")
        for fn in (lambda: jr.get_info(data),
                   lambda: jr.decode(data, OutputFormat.HDR_LINEAR, 4.0),
                   lambda: codec.decode_jpeg(data, "cpu")):
            try:
                fn()
            except UhdrError:
                pass

    def test_random_bytes(self):
        rng = np.random.default_rng(0)
        for size in (0, 1, 2, 16, 256, 4096):
            for _ in range(8):
                self._poke(rng.integers(0, 256, size,
                                        dtype=np.uint8).tobytes())

    def test_jpeg_prefixed_garbage(self):
        rng = np.random.default_rng(1)
        for _ in range(16):
            body = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
            self._poke(b"\xff\xd8" + body)
            self._poke(b"\xff\xd8\xff\xe1" + body)

    def test_truncated_real_file(self):
        blob = JpegR("cpu").encode_api0(_p010(32, 32), ColorTransfer.HLG)
        for cut in (2, 10, len(blob) // 4, len(blob) // 2, len(blob) - 5):
            self._poke(blob[:cut])

    def test_bitflipped_real_file(self):
        blob = bytearray(JpegR("cpu").encode_api0(_p010(32, 32),
                                                  ColorTransfer.HLG))
        rng = np.random.default_rng(2)
        for _ in range(12):
            mutated = bytearray(blob)
            for pos in rng.integers(2, len(blob), 4):
                mutated[pos] ^= 1 << int(rng.integers(0, 8))
            self._poke(bytes(mutated))

    def test_xmp_fuzz(self):
        rng = np.random.default_rng(3)
        for _ in range(16):
            payload = (xmp.XMP_NAMESPACE.encode() + b"\x00"
                       + rng.integers(0, 256, 128, dtype=np.uint8).tobytes())
            try:
                xmp.get_metadata_from_xmp(payload)
            except UhdrError:
                pass

    def test_icc_fuzz(self):
        rng = np.random.default_rng(4)
        for _ in range(16):
            data = (icc.ICC_IDENTIFIER
                    + rng.integers(0, 256, 200, dtype=np.uint8).tobytes())
            assert icc.read_icc_color_gamut(data) in (
                "bt709", "p3", "bt2100", "unspecified")


class TestEncodeFuzz:
    """Random valid configs must encode to decodable JPEG/R
    (enc fuzzer analog: dims within bounds, gamut/TF/quality sweeps)."""

    @pytest.mark.parametrize("seed", range(6))
    def test_random_config_roundtrip(self, seed):
        rng = np.random.default_rng(100 + seed)
        w = int(rng.integers(1, 12)) * 8
        h = int(rng.integers(1, 12)) * 8
        gamut = [ColorGamut.BT709, ColorGamut.P3,
                 ColorGamut.BT2100][int(rng.integers(0, 3))]
        tf = [ColorTransfer.HLG, ColorTransfer.PQ,
              ColorTransfer.LINEAR][int(rng.integers(0, 3))]
        quality = int(rng.integers(10, 101))
        img = _p010(h, w, seed)
        img.gamut = gamut
        blob = JpegR("cpu").encode_api0(img, tf, quality=quality)
        res = JpegR("cpu").decode(blob, OutputFormat.HDR_LINEAR, 4.0)
        assert (res.width, res.height) == (w, h)

    def test_odd_dims_rejected(self):
        img = _p010(32, 32)
        img.width = 31
        with pytest.raises(UhdrError):
            JpegR("cpu").encode_api0(img, ColorTransfer.HLG)

    def test_tiny_and_bounds(self):
        blob = JpegR("cpu").encode_api0(_p010(8, 8), ColorTransfer.HLG)
        res = JpegR("cpu").decode(blob, OutputFormat.HDR_LINEAR, 2.0)
        assert (res.width, res.height) == (8, 8)
        img = _p010(8, 8)
        img.width = 9000  # beyond kMaxWidth
        with pytest.raises(UhdrError):
            JpegR("cpu").encode_api0(img, ColorTransfer.HLG)


class TestSubsamplingEncodeFuzz:
    """Random dims/content through the 4:2:2 and 4:4:4 encode paths
    must produce JPEGs the decoder accepts."""

    @pytest.mark.parametrize("seed", range(4))
    def test_random_subsampled_roundtrip(self, seed):
        rng = np.random.default_rng(300 + seed)
        hs, vs = [(2, 1), (1, 1)][seed % 2]
        w = int(rng.integers(9, 140))
        h = int(rng.integers(9, 140))
        y = rng.integers(0, 256, (h, w), np.uint8)
        ch, cw = -(-h // vs), -(-w // hs)
        u = rng.integers(0, 256, (ch, cw), np.uint8)
        v = rng.integers(0, 256, (ch, cw), np.uint8)
        q = int(rng.integers(30, 101))
        blob = codec.encode_jpeg({"y": y, "u": u, "v": v}, quality=q,
                                 device="cpu")
        dec = codec.decode_jpeg(blob, "cpu")
        assert (dec.width, dec.height) == (w, h)
        assert tuple(dec.sampling[0]) == (hs, vs)


class TestProgressiveFuzz:
    """Mutations and truncations of a real progressive JPEG, which the
    port's decoder accepts: each run goes through the native progressive
    scan decoders (jpeg/entropy.cpp uhdr_prog_*) and must raise UhdrError
    or return a result, never crash."""

    def _prog_jpeg(self):
        import io
        pil = pytest.importorskip("PIL.Image")
        rng = np.random.default_rng(5)
        rgb = rng.integers(0, 255, (40, 56, 3), np.uint8)
        buf = io.BytesIO()
        pil.fromarray(rgb).save(buf, "JPEG", progressive=True,
                                quality=80, subsampling=2)
        return bytearray(buf.getvalue())

    def test_progressive_bitflips(self):
        base = self._prog_jpeg()
        rng = np.random.default_rng(6)
        for _ in range(24):
            data = bytearray(base)
            for _ in range(rng.integers(1, 6)):
                pos = rng.integers(2, len(data))
                data[pos] ^= 1 << rng.integers(0, 8)
            try:
                codec.decode_jpeg(bytes(data), "cpu")
            except UhdrError:
                pass

    def test_progressive_truncations(self):
        base = self._prog_jpeg()
        for frac in (0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
            try:
                codec.decode_jpeg(bytes(base[: int(len(base) * frac)]),
                                  "cpu")
            except UhdrError:
                pass


class TestEntropyDecoderFuzz:
    """Random bitstreams, table configs and block counts against the
    native entropy decoder (the port's jpeg/entropy.cpp): it must return
    an error, never corrupt memory."""

    def _tables(self):
        from libultrahdr_dev_tpu_torch.jpeg import tables
        return ([(tables.DC_LUMA_BITS, tables.DC_LUMA_VALS), None,
                 None, None],
                [(tables.AC_LUMA_BITS, tables.AC_LUMA_VALS), None,
                 None, None])

    @pytest.mark.parametrize("seed", range(8))
    def test_random_bitstreams(self, seed):
        dct, act = self._tables()
        rng = np.random.default_rng(seed)
        n = int(rng.integers(1, 64))
        data = rng.integers(0, 255, rng.integers(0, 512),
                            dtype=np.uint8).tobytes()
        comp_ids = np.zeros(n, np.uint8)
        try:
            out = codec.entropy_decode(data, n, comp_ids, [0], [0],
                                       dct, act,
                                       int(rng.integers(0, 4)), 1)
            assert out.shape == (n, 64)
        except UhdrError:
            pass

    @pytest.mark.parametrize("seed", range(4))
    def test_native_and_jax_python_agree_on_garbage(self, seed):
        """The port's C++ decoder and the JAX package's pure-Python one
        accept / reject the same garbage (differing only in which block
        they fail at)."""
        from libultrahdr_dev_tpu.jpeg import huffman
        dct, act = self._tables()
        rng = np.random.default_rng(100 + seed)
        n = 16
        data = rng.integers(0, 255, 256, dtype=np.uint8).tobytes()
        comp_ids = np.zeros(n, np.uint8)
        try:
            nat = codec.entropy_decode(data, n, comp_ids, [0], [0],
                                       dct, act, 0, 1)
        except UhdrError:
            nat = None
        try:
            py = huffman.huff_decode(data, n, comp_ids, [0], [0],
                                     dct, act, 0, 1)
        except (ValueError, IndexError):
            py = None
        if nat is not None and py is not None:
            assert np.array_equal(nat, py)


_AVIFR: list = []


def _avifr() -> bytes:
    """An AVIF_R of the port (a 64x64 P010 frame), written once."""
    if not _AVIFR:
        _AVIFR.append(HeifR("avif", "cpu").encode_api0(
            _p010(64, 64, seed=9), ColorTransfer.HLG, quality=80))
    return _AVIFR[0]


class TestIsobmffFuzz:
    """The HEIF container parser (container/isobmff.py) and HeifR front
    end must reject arbitrary/mutated boxes cleanly."""

    def _poke(self, data: bytes):
        from libultrahdr_dev_tpu_torch.container import isobmff as iso
        try:
            iso.parse_heif(data)
        except UhdrError:
            pass
        if heif_available():
            try:
                HeifR("avif", "cpu").decode(data)
            except UhdrError:
                pass

    def test_random_boxes(self):
        rng = np.random.default_rng(9)
        for _ in range(16):
            self._poke(rng.integers(0, 255, rng.integers(0, 512),
                                    dtype=np.uint8).tobytes())

    def test_mutated_sample(self):
        if not heif_available():
            pytest.skip("libheif not installed")
        base = bytearray(_avifr())
        rng = np.random.default_rng(10)
        for _ in range(24):
            data = bytearray(base)
            for _ in range(rng.integers(1, 8)):
                pos = rng.integers(0, len(data))
                data[pos] ^= 1 << rng.integers(0, 8)
            self._poke(bytes(data))

    def test_truncated_sample(self):
        if not heif_available():
            pytest.skip("libheif not installed")
        base = _avifr()
        for frac in (0.05, 0.2, 0.5, 0.8, 0.95):
            self._poke(base[: int(len(base) * frac)])


class TestMpfIccStructuralFuzz:
    """Structural (field-level) mutations of MPF and ICC payloads."""

    def test_mpf_mutations(self):
        from libultrahdr_dev_tpu_torch.container import mpf
        base = bytearray(mpf.generate_mpf(1000, 0, 500, 1500))
        rng = np.random.default_rng(11)
        for _ in range(24):
            data = bytearray(base)
            for _ in range(rng.integers(1, 5)):
                pos = rng.integers(0, len(data))
                data[pos] = rng.integers(0, 256)
            blob = (b"\xff\xd8" + b"\xff\xe2"
                    + (len(data) + 2).to_bytes(2, "big") + bytes(data)
                    + b"\xff\xd9")
            try:
                jfif.parse_jpeg_info(blob)
            except UhdrError:
                pass

    def test_icc_field_mutations(self):
        base = bytearray(icc.write_icc_profile("srgb", "bt709"))
        rng = np.random.default_rng(12)
        for _ in range(24):
            data = bytearray(base)
            # Mutate structural fields: size, tag count, tag offsets.
            for off in (0, 4, 128, 132, 136):
                if rng.integers(0, 2) and off + 4 <= len(data):
                    data[off:off + 4] = rng.integers(
                        0, 256, 4, dtype=np.uint8).tobytes()
            try:
                icc.read_icc_color_gamut(bytes(data))
            except UhdrError:
                pass


class TestExifGridFuzz:
    """Exif items and grid payloads must never crash the parser, only
    raise UhdrError or return None."""

    def _tmap_with_exif(self, exif_payload: bytes) -> bytes:
        from libultrahdr_dev_tpu_torch.container import isobmff as iso
        base = [iso.OutItem("hvc1", b"\x00" * 64,
                            [iso.ispe_prop(16, 16)])]
        gmap = [iso.OutItem("hvc1", b"\x00" * 32,
                            [iso.ispe_prop(4, 4)])]
        md = iso.encode_tmap_metadata(GainMapMetadata(
            max_content_boost=4.0, min_content_boost=1.0))
        blob = iso.build_tmap_container("heic", base, gmap, md,
                                        exif=b"XX")
        # splice arbitrary bytes over the Exif payload region
        return blob.replace(iso.encode_exif_item_payload(b"XX"),
                            exif_payload[:6].ljust(6, b"\0"))

    def test_exif_payload_mutations(self):
        from libultrahdr_dev_tpu_torch.container import isobmff as iso
        rng = np.random.default_rng(0)
        for n in (0, 1, 3, 4, 5, 64):
            payload = bytes(rng.integers(0, 256, n, dtype="uint8"))
            blob = self._tmap_with_exif(payload)
            try:
                hp = iso.parse_heif(blob)
                iso.find_exif(blob, hp, None)
            except Exception as e:
                assert isinstance(e, UhdrError), type(e)

    def test_exif_item_roundtrip_via_parser(self):
        from libultrahdr_dev_tpu_torch.container import isobmff as iso
        exif = b"Exif\x00\x00MM\x00*" + bytes(range(20))
        base = [iso.OutItem("hvc1", b"\x00" * 64,
                            [iso.ispe_prop(16, 16)])]
        gmap = [iso.OutItem("hvc1", b"\x00" * 32,
                            [iso.ispe_prop(4, 4)])]
        md = iso.encode_tmap_metadata(GainMapMetadata(
            max_content_boost=4.0, min_content_boost=1.0))
        blob = iso.build_tmap_container("heic", base, gmap, md,
                                        exif=exif)
        hp = iso.parse_heif(blob)
        assert iso.find_exif(blob, hp, 1) == exif
        # cdsc ref points from the Exif item to the base image
        exif_ids = [i for i, it in hp.items.items()
                    if it.item_type == "Exif"]
        assert len(exif_ids) == 1
        assert hp.refs[("cdsc", exif_ids[0])] == [1]

    def test_grid_payload_variants(self):
        from libultrahdr_dev_tpu_torch.container import isobmff as iso
        assert iso.grid_payload(2, 3, 100, 50) == bytes(
            [0, 0, 1, 2]) + (100).to_bytes(2, "big") + (50).to_bytes(
                2, "big")
        big = iso.grid_payload(2, 2, 70000, 50)
        assert big[1] == 1 and len(big) == 12


class TestPackioNativeFuzz:
    """The native pack-layer entry points (the port's parallel/
    packio.cpp) consume buffers that crossed the host-device link: they
    must reject or deterministically survive arbitrary bytes, never
    crash."""

    def _lib(self):
        from libultrahdr_dev_tpu_torch.jpeg import native
        return native.get_packio()

    def _call_unpack(self, bmap, blob, npads, n, h, w):
        from libultrahdr_dev_tpu_torch.parallel import packio
        woffs = np.zeros(8, np.int64)
        acc = 0
        for j, bw in enumerate(packio.FINE_WIDTHS):
            woffs[j] = acc
            acc += npads[j] * packio._wps(bw, packio.LF)
        blob = np.ascontiguousarray(blob, np.uint32)
        if blob.size < acc:
            blob = np.pad(blob, (0, acc - blob.size))
        scratch = np.empty(n * h * w, np.uint16)
        out = np.empty(n * h * w, np.uint32)
        bmap = np.ascontiguousarray(bmap)
        return self._lib().uhdr_rctseg_unpack(
            bmap.ctypes.data, blob.ctypes.data, woffs.ctypes.data, n, h, w,
            scratch.ctypes.data, out.ctypes.data)

    def test_invalid_width_codes_rejected(self):
        # every byte outside {0} + FINE_WIDTHS must return -3, not
        # index out of the rank table.
        from libultrahdr_dev_tpu_torch.parallel import packio
        n, h, w = 1, 32, 128
        nseg = 3 * n * h * ((w + 63) // 64)
        npads = tuple(32 for _ in range(8))
        valid = {0, *packio.FINE_WIDTHS}
        for bad in [7, 9, 11, 42, 255]:
            bmap = np.zeros(nseg, np.uint8)
            bmap[nseg // 2] = bad
            rc = self._call_unpack(bmap, np.zeros(8, np.uint32),
                                   npads, n, h, w)
            assert rc == -3, (bad, rc)
        assert all(v in valid for v in (0, 1, 2, 3, 4, 5, 6, 8, 10))

    def test_random_valid_widths_survive(self):
        # random VALID width codes with a random blob: garbage in,
        # deterministic garbage out, no crash, rc == 0.
        from libultrahdr_dev_tpu_torch.parallel import packio
        rng = np.random.default_rng(7)
        n, h, w = 1, 64, 200
        nseg = 3 * n * h * ((w + 63) // 64)
        codes = np.array([0, *packio.FINE_WIDTHS], np.uint8)
        bmap = codes[rng.integers(0, codes.size, nseg)]
        counts = {bw: int((bmap == bw).sum())
                  for bw in packio.FINE_WIDTHS}
        npads = tuple(packio._pow2_pad(max(counts[bw], 1), floor=32)
                      for bw in packio.FINE_WIDTHS)
        nwords = sum(npads[j] * packio._wps(bw, packio.LF)
                     for j, bw in enumerate(packio.FINE_WIDTHS))
        blob = rng.integers(0, 2**32, nwords, np.uint64).astype(
            np.uint32)
        rc = self._call_unpack(bmap, blob, npads, n, h, w)
        assert rc == 0

    def _call_rice(self, kmap, uwmap, blob, n, h, w):
        from libultrahdr_dev_tpu_torch.parallel import packio
        nonzero = kmap != packio._RICE_ZERO
        rem_counts = np.bincount(np.where(nonzero, kmap, 10),
                                 minlength=11)
        ucls = np.searchsorted(np.asarray(packio._RICE_UCLS, np.int64),
                               uwmap.astype(np.int64))
        un_counts = np.bincount(
            np.where(nonzero, np.minimum(ucls, 7), 7), minlength=8)
        rem_npads = tuple(int(rem_counts[j]) for j in range(10))
        un_npads = tuple(int(un_counts[c]) for c in range(7))
        rem_offs, un_offs = packio._rice_word_offs(rem_npads, un_npads)
        need = int(un_offs[-1] + un_npads[-1] * packio._RICE_UCLS[-1])
        blob = np.ascontiguousarray(blob, np.uint32)
        if blob.size < need:
            blob = np.pad(blob, (0, need - blob.size))
        scratch = np.empty(n * h * w, np.uint16)
        out = np.empty(n * h * w, np.uint32)
        kmap, uwmap = np.ascontiguousarray(kmap), np.ascontiguousarray(uwmap)
        rem_offs = np.ascontiguousarray(rem_offs, np.int64)
        un_offs = np.ascontiguousarray(un_offs, np.int64)
        return self._lib().uhdr_rice_unpack(
            kmap.ctypes.data, uwmap.ctypes.data, blob.ctypes.data,
            rem_offs.ctypes.data, un_offs.ctypes.data, n, h, w,
            scratch.ctypes.data, out.ctypes.data)

    def test_rice_random_maps_survive(self):
        # random valid-range k/uw maps with a random blob: the unary
        # bitmaps rarely carry exactly 256 terminators, so -5 (fail
        # closed) is the common outcome; 0 is fine; crashes are not.
        from libultrahdr_dev_tpu_torch.parallel import packio
        n, h, w = 1, 32, 512
        nseg = 3 * n * h * ((w + 255) // 256)
        for seed in range(5):
            rng = np.random.default_rng(seed)
            kmap = rng.choice(
                np.array([*range(10), packio._RICE_ZERO], np.uint8),
                nseg)
            uwmap = rng.integers(0, 25, nseg).astype(np.uint8)
            uwmap[kmap == packio._RICE_ZERO] = 0
            blob = rng.integers(0, 2**32, 1 << 16, np.uint64).astype(
                np.uint32)
            rc = self._call_rice(kmap, uwmap, blob, n, h, w)
            assert rc in (0, -5), (seed, rc)

    def test_rice_invalid_codes_rejected(self):
        n, h, w = 1, 32, 256
        nseg = 3 * n * h
        kmap = np.zeros(nseg, np.uint8)
        uwmap = np.full(nseg, 8, np.uint8)
        # at segment 0, before any bitmap decode can fail with -5
        kmap[0] = 11                          # invalid k code
        assert self._call_rice(kmap, uwmap, np.zeros(4, np.uint32),
                               n, h, w) == -3
        kmap[0] = 0
        uwmap[0] = 30                         # above the widest class
        assert self._call_rice(kmap, uwmap, np.zeros(4, np.uint32),
                               n, h, w) == -4

    def test_seg_widths_fill_roundtrip_random(self):
        # the native pack of random 10-bit noise agrees with the numpy
        # packer and unpacks exactly.
        from libultrahdr_dev_tpu_torch.parallel import packio
        rng = np.random.default_rng(11)
        arr = rng.integers(0, 1024, (64, 300)).astype(np.uint16)
        p = packio.pack_plane_host(arr)
        q = packio.pack_plane_host_numpy(arr)
        assert p.plan == q.plan and np.array_equal(p.perm, q.perm)
        for bw in packio.WIDTHS:
            assert np.array_equal(p.buckets[bw], q.buckets[bw])
        np.testing.assert_array_equal(packio.unpack_plane_host(p), arr)


class TestForeignScanFuzz:
    """The native lengths-only scan (entropy.cpp uhdr_huff_scan_offsets,
    behind device_decode.parse_device_stream) walks untrusted foreign
    bitstreams with raw pointer arithmetic; mutated/truncated streams
    must return None or raise — never crash the process or hand back a
    malformed DeviceStream."""

    def _foreign_jpeg(self):
        import io

        from PIL import Image
        rng = np.random.default_rng(77)
        img = rng.integers(0, 256, (96, 144, 3), np.uint8)
        img = ((img.astype(np.float32) + np.roll(img, 1, 0)) / 2
               ).astype(np.uint8)
        b = io.BytesIO()
        Image.fromarray(img).save(b, "JPEG", quality=90)
        return b.getvalue()

    def test_mutated_entropy_segment(self):
        from libultrahdr_dev_tpu_torch.jpeg import device_decode as dd
        blob = self._foreign_jpeg()
        assert dd.parse_device_stream(blob) is not None
        sos = blob.find(b"\xff\xda")
        body0 = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
        rng = np.random.default_rng(1)
        for trial in range(80):
            m = bytearray(blob)
            kind = trial % 4
            if kind == 0:        # random byte flips in the scan body
                for _ in range(rng.integers(1, 8)):
                    i = int(rng.integers(body0, len(m) - 2))
                    m[i] ^= int(rng.integers(1, 256))
            elif kind == 1:      # 0xFF / fake-marker injection
                i = int(rng.integers(body0, len(m) - 3))
                m[i:i + 2] = b"\xff" + bytes(
                    [int(rng.integers(0, 256))])
            elif kind == 2:      # truncation mid-scan
                m = m[:int(rng.integers(body0 + 1, len(m)))]
            else:                # garbage tail replacing the scan
                keep = int(rng.integers(body0, len(m)))
                m = m[:keep] + bytes(
                    rng.integers(0, 256, 64, np.uint8))
            try:
                ds = dd.parse_device_stream(bytes(m))
            except UhdrError:
                continue        # controlled rejection is fine
            if ds is not None:
                # Whatever survived must be structurally sound.
                assert ds.n_lanes >= 1
                assert ds.dest.dtype == np.uint8
