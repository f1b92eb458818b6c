"""libultrahdr_dev_tpu_torch: the PyTorch + CUDA port of
libultrahdr_dev_tpu, the Ultra HDR (JPEG/R) codec.

It imports torch and never JAX or the JAX package. This slice covers
the raw-input encodes and the decode: encode a P010 HDR frame (API-0),
or a P010 HDR frame with its YUV420 SDR rendition (API-1), into JPEG/R,
and decode a JPEG/R to HDR pixels (F16 linear, HLG or PQ RGBA1010102,
computed or through the transfer tables) or to SDR RGBA8888. Nine
hand-written CUDA kernels (kernels/csrc) run its device work on an
NVIDIA H100; on a CPU device each runs its plain PyTorch version:

  B1  ops.gainmap.encode_front                API-0 P010 -> gain map + BT.601
  B9  ops.gainmap.encode_front_api1           API-1 P010 + SDR -> the same
  B2  jpeg.dct.fdct_quant                     fDCT + quantization + zigzag
  B3  jpeg.device_entropy.encode_*_rst_stream restart-interval Huffman encode
  B4  jpeg.device_decode.decode_rst_chunks    parallel Huffman decode
  B5  jpeg.dct.dequant_idct                   dequantization + IDCT
  B6  ops.gainmap.apply_gainmap               gain-map apply + output pack
  B11 ops.gainmap.apply_gainmap(use_luts=True) the same with table TFs
  B7  ops.gainmap.yuv420_to_rgba8888          SDR output (fancy upsample)

The host keeps the marker work: byte stuffing and RSTn markers after
B3, parse and destuff before B4, and a host Huffman route (the port's
jpeg/entropy.cpp, built with g++) for streams the device decoder does
not take. Entry points run on the CUDA device unless the caller passes
device="cpu". Public surface:
  - api.UhdrEncoder (HDR and SDR raw intents) / api.UhdrDecoder /
    is_uhdr_image
  - jpegr.JpegR — encode_api0, encode_api1, decode, get_info
  - parallel.batched — batched_encode_api0 / batched_encode_api1 /
    batched_decode / batched_decode_from_handoff over a leading batch
    dimension on one device
"""

from .api import UhdrDecoder, UhdrEncoder, is_uhdr_image  # noqa: F401
from .jpegr import JpegR  # noqa: F401
from .types import (ColorGamut, ColorTransfer, CompressedImage,  # noqa: F401
                    GainMapMetadata, OutputFormat, PixelFormat, RawImage,
                    UhdrError)

__version__ = "0.1.0"
