"""C-style function surface of the port, mirroring ultrahdr_api.h names
1:1 as libultrahdr_dev_tpu/capi.py does.

For users porting call sites from the reference C API (ultrahdr_api.h:
200-581): each uhdr_* function maps onto the context objects in api.py.
Errors are returned as uhdr_error_info-like dicts ({"error_code",
"has_detail", "detail"}) instead of raising, matching C semantics. The
contexts run on the CUDA device unless uhdr_create_encoder /
uhdr_create_decoder are given another.
"""

from __future__ import annotations

from .api import (GAIN_MAP_IMG, HDR_IMG, SDR_IMG, BASE_IMG, UhdrDecoder,
                  UhdrEncoder)
from .api import is_uhdr_image as _is_uhdr_image
from .types import UhdrError

UHDR_CODEC_OK = {"error_code": "UHDR_CODEC_OK", "has_detail": 0,
                 "detail": ""}


def _trap(fn):
    try:
        fn()
        return dict(UHDR_CODEC_OK)
    except UhdrError as e:
        return {"error_code": e.code, "has_detail": 1, "detail": e.detail}
    except Exception as e:  # UNKNOWN_ERROR mapping
        return {"error_code": "UHDR_CODEC_UNKNOWN_ERROR", "has_detail": 1,
                "detail": str(e)}


# -- encoder ----------------------------------------------------------------

def uhdr_create_encoder(device="cuda") -> UhdrEncoder:
    return UhdrEncoder(device)


def uhdr_release_encoder(enc: UhdrEncoder) -> None:
    enc.reset()


def uhdr_enc_set_raw_image(enc, img, intent):
    return _trap(lambda: enc.set_raw_image(img, intent))


def uhdr_enc_set_compressed_image(enc, img, intent):
    return _trap(lambda: enc.set_compressed_image(img, intent))


def uhdr_enc_set_output_format(enc, media_type):
    return _trap(lambda: enc.set_output_format(media_type))


def uhdr_enc_set_gainmap_image(enc, img, metadata):
    return _trap(lambda: enc.set_gainmap_image(img, metadata))


def uhdr_enc_set_quality(enc, quality, intent=BASE_IMG):
    return _trap(lambda: enc.set_quality(quality, intent))


def uhdr_enc_set_exif_data(enc, exif):
    return _trap(lambda: enc.set_exif_data(exif))


def uhdr_encode(enc):
    return _trap(lambda: enc.encode())


def uhdr_get_encoded_stream(enc):
    try:
        return enc.get_encoded_stream()
    except UhdrError:
        return None


def uhdr_reset_encoder(enc):
    enc.reset()


# -- decoder ----------------------------------------------------------------

def uhdr_create_decoder(device="cuda") -> UhdrDecoder:
    return UhdrDecoder(device)


def uhdr_release_decoder(dec: UhdrDecoder) -> None:
    dec.reset()


def uhdr_dec_set_image(dec, data):
    return _trap(lambda: dec.set_image(data))


def uhdr_dec_set_out_img_format(dec, fmt):
    return _trap(lambda: dec.set_out_img_format(fmt))


def uhdr_dec_set_out_color_transfer(dec, ct):
    return _trap(lambda: dec.set_out_color_transfer(ct))


def uhdr_dec_set_out_max_display_boost(dec, boost):
    return _trap(lambda: dec.set_out_max_display_boost(boost))


def uhdr_dec_probe(dec):
    return _trap(lambda: dec.probe())


def uhdr_dec_get_image_width(dec) -> int:
    return dec.get_image_width()


def uhdr_dec_get_image_height(dec) -> int:
    return dec.get_image_height()


def uhdr_dec_get_gainmap_width(dec) -> int:
    return dec.get_gainmap_width()


def uhdr_dec_get_gainmap_height(dec) -> int:
    return dec.get_gainmap_height()


def uhdr_dec_get_exif(dec):
    return dec.get_exif()


def uhdr_dec_get_icc(dec):
    return dec.get_icc()


def uhdr_dec_get_gain_map_metadata(dec):
    return dec.get_gainmap_metadata()


def uhdr_decode(dec):
    return _trap(lambda: dec.decode())


def uhdr_get_decoded_image(dec):
    try:
        return dec.get_decoded_image()
    except UhdrError:
        return None


def uhdr_get_gain_map_image(dec):
    try:
        return dec.get_gain_map_image()
    except UhdrError:
        return None


def uhdr_reset_decoder(dec):
    dec.reset()


def is_uhdr_image(data, size=None) -> int:
    blob = data[:size] if size is not None else data
    return 1 if _is_uhdr_image(blob) else 0
