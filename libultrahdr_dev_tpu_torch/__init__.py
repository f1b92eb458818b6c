"""libultrahdr_dev_tpu_torch: the PyTorch + CUDA port of
libultrahdr_dev_tpu, the Ultra HDR (JPEG/R) codec.

It imports torch and never JAX or the JAX package. It covers the encode
APIs and the decode: API-0 (a P010 HDR frame), API-1 (with its YUV420
SDR rendition), API-2 / API-3 (with a given base JPEG), API-4 (mux) and
API-x (SDR + raw gain map) encode into JPEG/R, with EXIF and at any even
frame size; a JPEG/R decodes to HDR pixels (F16 linear, HLG or PQ
RGBA1010102, computed or through the transfer tables) or to SDR
RGBA8888 or to 10-bit planar linear RGB, with its gain-map plane; plain
JPEGs encode and decode (jpeg.codec.encode_jpeg / decode_jpeg); the
UltraHdr converter session edits a JPEG/R, JPEG, HEIC or AVIF or raw
planes (crop, mirror, rotate, resize) into a JPEG/R, a JPEG, a gain-map
HEIC/AVIF (HeifR), an 8-bit or 10-bit HEIC/AVIF or raw pixels. Hand-written CUDA kernels (kernels/csrc) run its device
work on an NVIDIA H100; on a CPU device each runs its plain PyTorch
version:

  B1   ops.gainmap.encode_front                API-0 P010 -> gain map + BT.601
  B9   ops.gainmap.encode_front_api1           API-1 P010 + SDR -> the same
  B10a ops.gainmap.tonemap_p010                P010 -> u8 YUV (general route)
  B10b ops.gainmap.generate_gainmap            gain map (general route)
  B10c ops.gainmap.convert_yuv_encoding        BT.601 re-encode (general route)
  B2   jpeg.dct.fdct_quant                     fDCT + quantization + zigzag
  B3   jpeg.device_entropy.encode_*_rst_stream restart-interval Huffman encode
       (B12-enc: encode_jpeg's restart intervals, any sampling)
  B19  jpeg.device_entropy.encode_*_stream     restart-less Huffman encode
  B4   jpeg.device_decode.decode_rst_chunks    parallel Huffman decode
  B22  the same with emit_mode="log"           (position, value) log + rebuild
       (or UHDR_DECODE_EMIT=log at import: every device decode)
  B5   jpeg.dct.dequant_idct                   dequantization + IDCT
  B12  jpeg.device_decode.decode_stream_device plain-JPEG decode (B4 + B5)
  B6   ops.gainmap.apply_gainmap               gain-map apply + output pack
  B11  ops.gainmap.apply_gainmap(use_luts=True) the same with table TFs
  B7   ops.gainmap.yuv420_to_rgba8888          SDR output (fancy upsample)
  B13  ops.editor.apply_effects                crop / mirror / rotate / resize

16-aligned API-0 / API-1 encodes without EXIF take the device route (B1
or B9, B2, B3; dense content as the JAX package writes it: API-0
restart-less through B19, API-1 on the general route); every other
encode takes the general route, as in the JAX package (B10a-c, B2, then
B19 for restart-less JPEGs). The host keeps the marker work: byte
stuffing and RSTn markers after B3 and B19, parse and destuff before
B4, and a host Huffman decoder (the port's jpeg/entropy.cpp, built with
g++) for streams the device decoder does not take; its encoder is the
reference the Huffman kernels are held against. Entry points run on the
CUDA device unless the caller passes device="cpu". Public surface:
  - api.UhdrEncoder (raw and compressed intents, EXIF) /
    api.UhdrDecoder / is_uhdr_image
  - jpegr.JpegR — encode_api0 .. encode_api4, encode_apix, decode
    (with the decoded gain-map plane), get_info
  - ultrahdr.UltraHdr / UltraHdrConfig — the converter session (add_image,
    add_raw, add_gainmap, convert to "jpeg" / "jpeg_r", convert_to_raw),
    with the effects of ops.editor (CropEffect, MirrorEffect,
    RotateEffect, ResizeEffect)
  - capi — the C-style uhdr_* calls and is_uhdr_image over api.py
  - heifr.HeifR — gain-map HEIC/AVIF (its own tmap container, coded
    images through the system libheif), encode API-0/1/x, SDR, decode
  - jpeg.codec — encode_jpeg, decode_jpeg
  - parallel.batched — batched_encode_api0 / batched_encode_api1 /
    batched_encode_device_stage / batched_decode /
    batched_decode_from_handoff / batched_apply_gainmap over a leading
    batch dimension on one device, or with mesh= over a mesh of them
  - parallel.mesh — default_mesh (every visible GPU, as the JAX
    package's sharding.default_mesh) / single_device_mesh / DeviceMesh,
    and ShardedBatch, a batch's per-device shards
  - utils.profiler — Profiler, StageTimes, device_trace (torch.profiler,
    a Chrome trace) and span, the program's named regions: off, a span
    is one shared no-op; inside `with profiler.recording():` or a
    device_trace each span's (name, thread, start, end) on the
    perf_counter clock is kept, and profiler.recorded() returns them
    after; inside a device_trace each span is also a user annotation of
    the Chrome trace, beside the kernels when opened in Perfetto
  - utils.counters — process-wide counts (snapshot()): the slower
    transfer paths, decode_route_host, h2d_bytes, kernels_built
"""

from .api import UhdrDecoder, UhdrEncoder, is_uhdr_image  # noqa: F401
from .heifr import HeifR  # noqa: F401
from .jpegr import JpegR  # noqa: F401
from .parallel.mesh import (DeviceMesh, ShardedBatch,  # noqa: F401
                            default_mesh, single_device_mesh)
from .ops.editor import (CropEffect, MirrorEffect, ResizeEffect,  # noqa: F401
                         RotateEffect)
from .types import (ColorGamut, ColorTransfer, CompressedImage,  # noqa: F401
                    GainMapMetadata, OutputFormat, PixelFormat, RawImage,
                    UhdrError)
from .ultrahdr import UltraHdr, UltraHdrConfig  # noqa: F401

__version__ = "0.1.0"
