"""The port's C-style API surface (libultrahdr_dev_tpu_torch/capi.py)
on the CPU: tests/test_capi.py's two cases with device="cpu", and the
C-style encode cycle's bytes and decoded pixels against the JAX
package's capi on the same seeded P010."""

import numpy as np

from libultrahdr_dev_tpu import capi as jcapi
from libultrahdr_dev_tpu.api import HDR_IMG as JHDR_IMG
from libultrahdr_dev_tpu.types import (ColorGamut as JGamut,
                                       ColorTransfer as JTransfer,
                                       PixelFormat as JPixelFormat,
                                       RawImage as JRawImage)
from libultrahdr_dev_tpu_torch import capi
from libultrahdr_dev_tpu_torch.api import HDR_IMG
from libultrahdr_dev_tpu_torch.types import (ColorGamut, ColorTransfer,
                                             PixelFormat, RawImage)

import test_torch_jax_native  # noqa: F401  (the JAX native library, built once)
import test_torch_threads  # noqa: F401  (caps torch's threads)


def p010(h=32, w=32):
    """tests/test_capi.py's frame."""
    rng = np.random.default_rng(0)
    return RawImage(
        fmt=PixelFormat.P010, width=w, height=h, gamut=ColorGamut.BT2100,
        transfer=ColorTransfer.HLG,
        planes={"y": (rng.integers(64, 940, (h, w)).astype(np.uint16)) << 6,
                "uv": np.full((h // 2, w), 512 << 6, np.uint16)})


def cycle(mod, img, intent, **kw):
    """The C-style encode then decode: (stream bytes, decoded image)."""
    enc = mod.uhdr_create_encoder(**kw)
    assert mod.uhdr_enc_set_raw_image(enc, img, intent)["error_code"] == \
        "UHDR_CODEC_OK"
    assert mod.uhdr_encode(enc)["error_code"] == "UHDR_CODEC_OK"
    data = mod.uhdr_get_encoded_stream(enc).data
    dec = mod.uhdr_create_decoder(**kw)
    assert mod.uhdr_dec_set_image(dec, data)["error_code"] == "UHDR_CODEC_OK"
    assert mod.uhdr_decode(dec)["error_code"] == "UHDR_CODEC_OK"
    return data, mod.uhdr_get_decoded_image(dec)


def test_c_style_encode_decode_cycle():
    enc = capi.uhdr_create_encoder("cpu")
    st = capi.uhdr_enc_set_raw_image(enc, p010(), HDR_IMG)
    assert st["error_code"] == "UHDR_CODEC_OK"
    st = capi.uhdr_encode(enc)
    assert st["error_code"] == "UHDR_CODEC_OK"
    stream = capi.uhdr_get_encoded_stream(enc)
    assert capi.is_uhdr_image(stream.data) == 1

    dec = capi.uhdr_create_decoder("cpu")
    assert capi.uhdr_dec_set_image(dec, stream.data)["error_code"] == \
        "UHDR_CODEC_OK"
    assert capi.uhdr_dec_probe(dec)["error_code"] == "UHDR_CODEC_OK"
    assert capi.uhdr_dec_get_image_width(dec) == 32
    assert capi.uhdr_dec_get_gainmap_height(dec) == 8
    assert capi.uhdr_dec_get_icc(dec) is not None
    assert capi.uhdr_decode(dec)["error_code"] == "UHDR_CODEC_OK"
    img = capi.uhdr_get_decoded_image(dec)
    assert img.fmt == PixelFormat.RGBA_F16
    capi.uhdr_reset_decoder(dec)
    capi.uhdr_release_encoder(enc)


def test_c_style_errors_returned_not_raised():
    enc = capi.uhdr_create_encoder("cpu")
    st = capi.uhdr_enc_set_quality(enc, 200)
    assert st["error_code"] == "UHDR_CODEC_INVALID_PARAM"
    assert st["has_detail"] == 1
    st = capi.uhdr_encode(enc)
    assert st["error_code"] == "UHDR_CODEC_INVALID_OPERATION"
    dec = capi.uhdr_create_decoder("cpu")
    st = capi.uhdr_dec_set_image(dec, b"")
    assert st["error_code"] == "UHDR_CODEC_INVALID_PARAM"
    assert capi.is_uhdr_image(b"junk") == 0


def test_c_style_cycle_as_jax():
    """The same seeded P010 through both C-style surfaces: identical
    JPEG/R bytes; F16 pixels within 1 ULP, >= 99.9% exact."""
    img = p010()
    jimg = JRawImage(fmt=JPixelFormat.P010, width=img.width,
                     height=img.height, gamut=JGamut.BT2100,
                     transfer=JTransfer.HLG, planes=img.planes)
    data, out = cycle(capi, img, HDR_IMG, device="cpu")
    jdata, jout = cycle(jcapi, jimg, JHDR_IMG)
    assert data == jdata
    got, want = out.planes["rgba"], np.asarray(jout.planes["rgba"])
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got[..., :3].astype(np.int64) - want[..., :3])
    assert int(d.max()) <= 1 and float((d == 0).mean()) >= 0.999
