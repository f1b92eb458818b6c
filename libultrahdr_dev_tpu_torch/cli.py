"""uhdr command-line tool on the CUDA GPU: the port of
libultrahdr_dev_tpu/cli.py, with its flags and outputs.

Mirrors the reference demo app's flag surface (libultrahdr
examples/ultrahdr_app.cpp:1060-1122):

  -m mode (0 encode / 1 decode)
  -p p010 raw  -y yuv420 raw  -i base jpeg  -g gainmap jpeg
  -f gainmap metadata config file (API-4, metadata.cfg format)
  -w/-h dims   -C hdr gamut  -c sdr gamut  -t hdr transfer
  -q quality   -e compute psnr
  -j jpegr input (decode)  -o out transfer  -O out format
  -z output file path (extension beyond the reference's stdout naming)
  --cpu runs on the CPU (the kernels' plain versions) instead of the GPU

Decode leaves the pixels on the device and writes them through the
packed readback (parallel/link.py fetch_pixels_packed): RGBA1010102 and
RGBA F16 ride the Rice packs, RGBA8888 is a raw copy. Run as

    python -m libultrahdr_dev_tpu_torch.cli -m 0 -p in.p010 -w W -h H -z out.jpg
    python -m libultrahdr_dev_tpu_torch.cli -m 1 -j out.jpg -o 1 -O 5 -z out.raw
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .api import BASE_IMG, HDR_IMG, SDR_IMG, UhdrDecoder, UhdrEncoder
from .container import mux
from .jpeg import codec
from .parallel.link import fetch_pixels_packed
from .types import (ColorGamut, ColorTransfer, CompressedImage,
                    GainMapMetadata, PixelFormat, RawImage)
from .utils import metrics

_GAMUTS = {0: ColorGamut.BT709, 1: ColorGamut.P3, 2: ColorGamut.BT2100}
_TFS = {0: ColorTransfer.LINEAR, 1: ColorTransfer.HLG, 2: ColorTransfer.PQ,
        3: ColorTransfer.SRGB}
_OUT_FMTS = {3: PixelFormat.RGBA8888, 4: PixelFormat.RGBA_F16,
             5: PixelFormat.RGBA1010102}


def load_p010(path: str, w: int, h: int, gamut, tf) -> RawImage:
    raw = np.fromfile(path, np.uint16)
    if raw.size < w * h * 3 // 2:
        raise SystemExit(f"{path}: too small for {w}x{h} P010")
    return RawImage(fmt=PixelFormat.P010, width=w, height=h, gamut=gamut,
                    transfer=tf,
                    planes={"y": raw[:w * h].reshape(h, w),
                            "uv": raw[w * h:w * h * 3 // 2].reshape(
                                h // 2, w)})


def load_yuv420(path: str, w: int, h: int, gamut) -> RawImage:
    raw = np.fromfile(path, np.uint8)
    if raw.size < w * h * 3 // 2:
        raise SystemExit(f"{path}: too small for {w}x{h} YUV420")
    return RawImage(fmt=PixelFormat.YUV420, width=w, height=h, gamut=gamut,
                    transfer=ColorTransfer.SRGB,
                    planes={"y": raw[:w * h].reshape(h, w),
                            "u": raw[w * h:w * h * 5 // 4].reshape(
                                h // 2, w // 2),
                            "v": raw[w * h * 5 // 4:w * h * 3 // 2].reshape(
                                h // 2, w // 2)})


def parse_metadata_cfg(path: str) -> GainMapMetadata:
    """examples/metadata.cfg format: '--key value' lines."""
    vals = {}
    with open(path) as f:
        for line in f:
            parts = line.replace("--", "").split()
            if len(parts) >= 2:
                vals[parts[0].lower()] = float(parts[1])
    md = GainMapMetadata()
    md.max_content_boost = vals.get("maxcontentboost", 1.0)
    md.min_content_boost = vals.get("mincontentboost", 1.0)
    md.gamma = vals.get("gamma", 1.0)
    md.offset_sdr = vals.get("offsetsdr", 0.0)
    md.offset_hdr = vals.get("offsethdr", 0.0)
    md.hdr_capacity_min = vals.get("hdrcapacitymin", 1.0)
    md.hdr_capacity_max = vals.get("hdrcapacitymax", md.max_content_boost)
    return md


def main(argv=None) -> int:
    # add_help disabled so -h can mean image height like the reference
    # app; use --help.
    ap = argparse.ArgumentParser(
        prog="uhdr", description="Ultra HDR codec on the CUDA GPU",
        add_help=False)
    ap.add_argument("--help", action="help",
                    help="show this help message and exit")
    ap.add_argument("-m", type=int, default=0, dest="mode",
                    help="0: encode, 1: decode")
    ap.add_argument("-p", dest="p010_file")
    ap.add_argument("-y", dest="yuv420_file")
    ap.add_argument("-i", dest="base_jpeg_file")
    ap.add_argument("-g", dest="gainmap_jpeg_file")
    ap.add_argument("-f", dest="metadata_cfg")
    ap.add_argument("-w", type=int, dest="width", default=0)
    ap.add_argument("-h", "-H", "--height", type=int, dest="height",
                    default=0)
    ap.add_argument("-C", type=int, dest="hdr_gamut", default=0)
    ap.add_argument("-c", type=int, dest="sdr_gamut", default=0)
    ap.add_argument("-t", type=int, dest="hdr_tf", default=1)
    ap.add_argument("-q", type=int, dest="quality", default=100)
    ap.add_argument("-e", type=int, dest="psnr", default=0)
    ap.add_argument("-j", dest="jpegr_file")
    ap.add_argument("-o", type=int, dest="out_tf", default=1)
    ap.add_argument("-O", type=int, dest="out_fmt", default=5)
    ap.add_argument("-z", dest="out_file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.mode == 0:
        return encode_mode(args, device)
    if args.mode == 1:
        return decode_mode(args, device)
    ap.error(f"invalid mode {args.mode}")


def encode_mode(args, device) -> int:
    enc = UhdrEncoder(device)
    hdr_gamut = _GAMUTS.get(args.hdr_gamut, ColorGamut.BT709)
    sdr_gamut = _GAMUTS.get(args.sdr_gamut, ColorGamut.BT709)
    hdr_tf = _TFS.get(args.hdr_tf, ColorTransfer.HLG)

    if args.p010_file:
        if not args.width or not args.height:
            raise SystemExit("encode with -p requires -w and -h")
        enc.set_raw_image(load_p010(args.p010_file, args.width,
                                    args.height, hdr_gamut, hdr_tf),
                          HDR_IMG)
    if args.yuv420_file:
        enc.set_raw_image(load_yuv420(args.yuv420_file, args.width,
                                      args.height, sdr_gamut), SDR_IMG)
    if args.base_jpeg_file:
        with open(args.base_jpeg_file, "rb") as f:
            data = f.read()
        if args.gainmap_jpeg_file:
            enc.set_compressed_image(CompressedImage(data=data), BASE_IMG)
            with open(args.gainmap_jpeg_file, "rb") as f:
                gm_data = f.read()
            if not args.metadata_cfg:
                raise SystemExit("API-4 requires -f metadata.cfg")
            enc.set_gainmap_image(CompressedImage(data=gm_data),
                                  parse_metadata_cfg(args.metadata_cfg))
        else:
            enc.set_compressed_image(CompressedImage(data=data), SDR_IMG)
    enc.set_quality(args.quality, BASE_IMG)

    t0 = time.perf_counter()
    out = enc.encode()
    dt = (time.perf_counter() - t0) * 1000
    out_path = args.out_file or "out.jpeg"
    with open(out_path, "wb") as f:
        f.write(out.data)
    print(f"encoded {out_path} ({len(out.data)} bytes) in {dt:.2f} ms")

    if args.psnr and args.p010_file:
        primary, _ = mux.read_primary_and_gainmap(out.data)
        base = codec.decode_jpeg(primary, device)
        p010 = load_p010(args.p010_file, args.width, args.height,
                         _GAMUTS.get(args.hdr_gamut), ColorTransfer.HLG)
        py, pu, pv = metrics.p010_yuv420_psnr(
            p010.planes["y"], p010.planes["uv"],
            *(base.planes[k].cpu().numpy() for k in range(3)))
        print(f"psnr y {py:.4f} u {pu:.4f} v {pv:.4f}")
    return 0


def decode_mode(args, device) -> int:
    if not args.jpegr_file:
        raise SystemExit("decode requires -j <jpegr>")
    with open(args.jpegr_file, "rb") as f:
        data = f.read()
    dec = UhdrDecoder(device, pixels_on_device=True)
    dec.set_image(data)
    dec.set_out_color_transfer(_TFS.get(args.out_tf, ColorTransfer.HLG))
    dec.set_out_img_format(_OUT_FMTS.get(args.out_fmt,
                                         PixelFormat.RGBA1010102))
    t0 = time.perf_counter()
    img = dec.decode()
    dt = (time.perf_counter() - t0) * 1000
    print(f"decoded {dec.get_image_width()}x{dec.get_image_height()} "
          f"(gainmap {dec.get_gainmap_width()}x{dec.get_gainmap_height()},"
          f" maxboost {dec.get_gainmap_metadata().max_content_boost:.4f})"
          f" in {dt:.2f} ms")
    out_path = args.out_file or "out.raw"
    # The pixels are still on the device: the packed readback brings
    # them over, bit-identical to a raw copy.
    np.ascontiguousarray(fetch_pixels_packed(
        img.planes["rgba"], fmt=img.fmt)).tofile(out_path)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
