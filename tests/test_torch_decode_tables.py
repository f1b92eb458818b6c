"""The device decoder's Huffman decode tables built natively
(libultrahdr_dev_tpu_torch/jpeg/device_decode.py build_tables, one pass
of jpeg/entropy.cpp uhdr_decode_tables) against their Python model
(decode_tables_plain), byte for byte, on every kind of DHT the lenient
header reader (jpeg/headers.py read_dht) passes; and pack_streams'
tables, span and counter."""

import numpy as np
import pytest

from libultrahdr_dev_tpu_torch.jpeg import device_decode as tdd, headers
from libultrahdr_dev_tpu_torch.jpeg import tables
from libultrahdr_dev_tpu_torch.utils import counters, profiler

from test_torch_device_decode import _table_sets

import test_torch_threads  # noqa: F401  (caps torch's threads)

DC = (tables.DC_LUMA_BITS, tables.DC_LUMA_VALS)
AC = (tables.AC_LUMA_BITS, tables.AC_LUMA_VALS)


def _lenient(bits, vals):
    """(bits, vals) of a DHT payload of one DC table as read_dht reads
    it, and the fault a strict reader finds in it (None if none)."""
    out, error, stopped = headers.read_dht(bytes([0x00, *bits, *vals]))
    assert not stopped and len(out) == 1
    return tuple(out[0][2:]), error


def _assert_native_is_plain(sets):
    got = tdd.build_tables(sets)
    assert got.shape == (len(sets), 4, tdd.TABLE_WORDS)
    assert got.dtype == np.int32
    for g, specs in zip(got, sets):
        assert g.tobytes() == tdd.decode_tables_plain(specs).tobytes()
    return got


# A DHT whose counts are not canonical: 255 one-bit codes, then one of
# 16 bits; the codes run past their lengths, the boundaries past 16 bits.
NON_CANONICAL = _lenient([255] + [0] * 14 + [1], list(range(256)))
# Symbols that repeat: the later occurrence keeps its code.
REPEATS = _lenient([0, 3, 2] + [0] * 13, [4, 1, 4, 9, 1])
# 256 codes, every symbol once.
FULL = _lenient([0] * 7 + [255, 1] + [0] * 7,
                [int(s) for s in np.random.default_rng(7).permutation(256)])
# Two symbols: the vals row is mostly zero padding, which must not read
# as entries of symbol 0.
PADDED = _lenient([0, 2] + [0] * 14, [7, 9])


def _random_lenient(rng):
    """A random DHT read_dht passes: up to 256 counts over lengths 1-16,
    canonical or not, and random symbols that may repeat."""
    n = int(rng.integers(1, 257))
    bits = rng.multinomial(n, rng.dirichlet(np.full(16, 0.3)))
    i = int(np.argmax(bits))
    if bits[i] > 255:   # all 256 codes at one length: a count too many
        bits[i] -= 1
        bits[(i + 1) % 16] += 1
    return _lenient([int(b) for b in bits],
                    [int(v) for v in rng.integers(0, 256, n)])[0]


@pytest.mark.parametrize("name", list(_table_sets()))
def test_native_tables_equal_plain(name):
    """Annex K color and gray, the one-bit tables, four random DHTs."""
    _assert_native_is_plain([_table_sets()[name]])


def test_non_canonical_boundaries_past_16_bits():
    (bits, vals), error = NON_CANONICAL
    assert error is not None   # a strict reader refuses the counts
    got = _assert_native_is_plain([((bits, vals), AC, None, None)])
    n = got[0, 0, 0]
    assert n == 256 and got[0, 0, n] > 1 << 22


def test_repeated_symbols_keep_their_last_code():
    spec, _ = REPEATS
    got = _assert_native_is_plain([(spec, AC, spec, AC)])
    # 4 keeps 0b10 (2 bits), 9 has 0b110 and 1 keeps 0b111 (3 bits)
    assert got[0, 0, 0] == 3
    assert list(got[0, 0, 1:4]) == [2 << 14, 6 << 13, 7 << 13]
    assert list(got[0, 0, 257:260]) == [(4 << 5) | 2, (9 << 5) | 3,
                                        (1 << 5) | 3]


def test_no_two_entries_tie_on_boundary():
    """Annex C gives each code a boundary above the last one's, whatever
    the counts, so no two entries of a table tie on boundary and the
    (boundary, packed) order is the boundary order: checked on 64
    random lenient DHTs, native and plain alike."""
    rng = np.random.default_rng(29)
    specs = [_random_lenient(rng) for _ in range(64)]
    got = _assert_native_is_plain([tuple(specs[i:i + 4])
                                   for i in range(0, 64, 4)])
    for tab in got.reshape(-1, tdd.TABLE_WORDS):
        assert (np.diff(tab[1:1 + tab[0]]) > 0).all()


def test_full_256_code_table():
    spec, error = FULL
    assert error is None
    got = _assert_native_is_plain([(DC, spec, DC, spec)])
    assert got[0, 1, 0] == 256 and got[0, 3, 0] == 256


def test_zero_padded_vals_row():
    spec, _ = PADDED
    got = _assert_native_is_plain([(spec, spec, None, None)])
    for t in range(4):
        assert got[0, t, 0] == 2
        assert not got[0, t, 3:257].any() and not got[0, t, 259:].any()


def test_many_tables_in_one_call():
    """T = 64: every case above and the Annex K and random sets mixed."""
    rng = np.random.default_rng(64)
    cases = [NON_CANONICAL[0], REPEATS[0], FULL[0], PADDED[0], DC, AC]
    sets = list(_table_sets().values())
    while len(sets) < 16:
        k = rng.integers(0, len(cases), 4)
        gray = bool(rng.integers(0, 2))
        sets.append((cases[k[0]], cases[k[1]],
                     *((None, None) if gray else (cases[k[2]],
                                                  cases[k[3]]))))
    _assert_native_is_plain(sets)


def test_more_than_256_codes_raise():
    bad = ([255, 2] + [0] * 14, list(range(256)))
    with pytest.raises(ValueError):
        tdd.build_tables([(DC, bad, None, None)])


def _stream(specs, gray, n_lanes=3):
    return tdd.DeviceStream(
        width=16, height=16, gray=gray, restart_interval=1,
        dest=np.arange(40, dtype=np.uint8),
        starts_byte=np.arange(n_lanes, dtype=np.int32) * 8, win_len=48,
        qtables=[], specs=specs, mcus_x=1, mcus_y=1)


def test_pack_streams_tables_span_and_counter():
    """One pack_streams over Annex K and random-DHT streams: each
    frame's tables are the plain model's, one "decode.tables" span, the
    counter up by the stream count."""
    sets = _table_sets()
    color = [sets["annex_k_color"], sets["random_0"], sets["random_1"],
             sets["annex_k_color"], sets["one_bit"]]
    gray = [sets["annex_k_gray"], sets["random_2"][:2] + (None, None),
            sets["annex_k_gray"]]
    for group, is_gray in ((color, False), (gray, True)):
        before = counters.snapshot().get("decode_table_sets", 0)
        with profiler.recording():
            ln = tdd.pack_streams([_stream(s, is_gray) for s in group])
        spans = [n for n, *_ in profiler.recorded() if n == "decode.tables"]
        assert spans == ["decode.tables"]
        assert (counters.snapshot()["decode_table_sets"]
                == before + len(group))
        assert ln.tables.shape == (len(group), 4, tdd.TABLE_WORDS)
        for tab, specs in zip(ln.tables, group):
            assert tab.tobytes() == tdd.decode_tables_plain(specs).tobytes()


def test_no_route_builds_tables_in_python(monkeypatch):
    """decode_tables and pack_streams never reach the Python model."""
    def refuse(*_):
        raise AssertionError("the Python table build ran")

    monkeypatch.setattr(tdd, "_chain_consts", refuse)
    specs = tdd.ANNEX_K_COLOR
    assert tdd.decode_tables(specs).shape == (4, tdd.TABLE_WORDS)
    assert tdd.pack_streams([_stream(specs, False)]).tables.shape == (
        1, 4, tdd.TABLE_WORDS)
