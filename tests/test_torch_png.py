"""The port's self-contained PNG decoder (``nerf_tpu_torch/runtime/png.cpp``)
against the JAX package's native decoder, which is built on libpng here and
so is the oracle, bit for bit: every colour type and bit depth, tRNS keys at
8 and 16 bits, Adam7 (down to images smaller than one 8 x 8 block), each row
filter, stored / fixed / dynamic deflate streams, IDATs split byte by byte,
ancillary chunks, an 800 x 800 image, a hypothesis sweep; then corrupt files,
which both decoders must refuse, the port's raising with the file's name.

The PNGs are written here, with ``zlib`` and a numpy filter encoder, so each
case controls its chunks, filters and stream."""

import ctypes
import re
import struct
import tempfile
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nerf_tpu_torch import runtime

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
W, H = 13, 9
SIZES = {"own_size": None, "resized": (20, 7)}


def chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[h, w, c]`` samples at ``depth`` bits -> ``[h, rowbytes]`` bytes.
    Sub-byte rows are packed most significant bit first, and their padding
    bits at the row's end are set to 1 (a decoder must ignore them)."""
    h, w, c = samples.shape
    flat = samples.reshape(h, w * c).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    pad = (-bits.shape[1]) % 8
    bits = np.concatenate([bits, np.ones((h, pad), np.int64)], axis=1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def filter_rows(raw: np.ndarray, bpp: int, types) -> np.ndarray:
    """Each row of ``raw`` under its filter type (0-4), with its filter
    byte in front."""
    raw = raw.astype(np.int32)
    n = raw.shape[1]
    prev = np.vstack([np.zeros((1, n), np.int32), raw[:-1]])
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, :n]
    upleft = np.pad(prev, ((0, 0), (bpp, 0)))[:, :n]
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    encoded = (raw, raw - left, raw - prev, raw - (left + prev) // 2, raw - paeth)
    rows = np.stack([encoded[t][i] for i, t in enumerate(types)]) & 0xFF
    return np.concatenate([np.asarray(types)[:, None], rows], axis=1).astype(np.uint8)


def png_bytes(samples, color, depth, palette=None, trns=None, interlace=False, filters=0,
              level=6, strategy=zlib.Z_DEFAULT_STRATEGY, idat_size=None, ancillary=False,
              stream=None) -> bytes:
    """A PNG of ``samples`` (``[h, w, channels]`` at the file's depth;
    palette indices for colour type 3). ``filters``: one type for every
    row, or ``"mixed"`` (row i of the stream under type i % 5).
    ``stream``: the filtered image data instead of the encoder's."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if stream is None:
        parts, row = [], 0
        for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] == 0 or sub.shape[1] == 0:
                continue                                 # an empty pass has no rows
            types = ((np.arange(sub.shape[0]) + row) % 5 if filters == "mixed"
                     else [filters] * sub.shape[0])
            parts.append(filter_rows(pack_rows(sub, depth), bpp, types).tobytes())
            row += sub.shape[0]
        stream = b"".join(parts)
    comp = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    data = comp.compress(stream) + comp.flush()
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                                  int(interlace)))
    if ancillary:
        out += (chunk(b"gAMA", struct.pack(">I", 45455)) + chunk(b"sRGB", b"\x00")
                + chunk(b"tEXt", b"Comment\x00written by the test")
                + chunk(b"prVt", b"an unknown ancillary chunk"))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    if ancillary:
        out += chunk(b"pHYs", struct.pack(">IIB", 2835, 2835, 1))
    step = idat_size or len(data)
    for k in range(0, len(data), step):
        out += chunk(b"IDAT", data[k:k + step])
    if ancillary:
        out += chunk(b"tIME", struct.pack(">HBBBBB", 2024, 1, 2, 3, 4, 5))
    return out + chunk(b"IEND", b"")


def make_image(kind: str, w: int, h: int, seed: int = 0):
    """``(samples, color, depth, palette, trns)`` for a kind such as
    ``grey4``, ``pal2_trns``, ``rgb16_trns``, ``rgba8``. A tRNS key is
    planted in about a quarter of the pixels; at 16 bits another quarter
    shares the key's high byte only."""
    rng = np.random.default_rng(seed)
    m = re.fullmatch(r"(grey_alpha|grey|rgba|rgb|pal)(\d+)(_trns)?", kind)
    name, depth, with_trns = m.group(1), int(m.group(2)), bool(m.group(3))
    color = {"grey": 0, "rgb": 2, "pal": 3, "grey_alpha": 4, "rgba": 6}[name]
    c = CHANNELS[color]
    palette = trns = None
    if color == 3:
        n_pal = min(1 << depth, 200)
        samples = rng.integers(0, n_pal, (h, w, 1))
        palette = rng.integers(0, 256, (n_pal, 3))
        if with_trns:                                    # shorter than the palette
            trns = bytes(rng.integers(0, 256, max(1, n_pal - 1), dtype=np.uint8).tolist())
        return samples, color, depth, palette, trns
    samples = rng.integers(0, 1 << depth, (h, w, c))
    if with_trns:
        key = rng.integers(0, 1 << depth, c)
        pick = rng.random((h, w))
        samples[pick < 0.25] = key
        if depth == 16:                                  # the high byte alone is no match
            samples[(pick >= 0.25) & (pick < 0.5)] = (key & 0xFF00) | ((key + 1) & 0xFF)
        trns = b"".join(struct.pack(">H", int(k)) for k in key)
    return samples, color, depth, palette, trns


KINDS = ("grey1", "grey2", "grey4", "grey8", "grey16", "grey2_trns", "grey8_trns",
         "grey16_trns", "rgb8", "rgb16", "rgb8_trns", "rgb16_trns", "pal1", "pal2", "pal4",
         "pal8", "pal1_trns", "pal4_trns", "pal8_trns", "grey_alpha8", "grey_alpha16", "rgba8",
         "rgba16")


@pytest.fixture(scope="module")
def libpng():
    """The JAX package's native decoder, called directly (its Python
    wrapper would decode a refused file with PIL instead): ``(failures,
    out)``."""
    from nerf_tpu import runtime as jruntime

    lib = jruntime.load_library()
    if lib is None:
        pytest.skip("the JAX package's native runtime does not load here")

    def decode(paths, wh, white=True, threads=1):
        out = np.zeros((len(paths), wh[1], wh[0], 3), np.float32)
        failures = lib.nerf_decode_png_batch(
            "\n".join(str(p) for p in paths).encode(), len(paths),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), wh[0], wh[1], int(white), threads)
        return failures, out

    return decode


def assert_same_as_libpng(paths, wh, libpng):
    for white in (True, False):
        failures, ref = libpng(paths, wh, white)
        assert failures == 0
        for threads in (1, 4):
            got = runtime.decode_png_batch(paths, wh, white_background=white, n_threads=threads)
            np.testing.assert_array_equal(got, ref, err_msg=f"white={white} threads={threads}")


def write(path: Path, data: bytes) -> Path:
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("size", SIZES.values(), ids=SIZES.keys())
@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_matches_libpng(kind, interlace, size, tmp_path, libpng):
    paths = []
    for seed in range(3):
        samples, color, depth, palette, trns = make_image(kind, W, H, seed)
        paths.append(write(tmp_path / f"{kind}_{seed}.png",
                           png_bytes(samples, color, depth, palette, trns, interlace,
                                     filters="mixed")))
    assert_same_as_libpng(paths, size or (W, H), libpng)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", ["rgba8", "rgb16", "grey4", "pal8"])
def test_each_row_filter_matches_libpng(kind, filters, tmp_path, libpng):
    samples, color, depth, palette, trns = make_image(kind, 31, 17)
    path = write(tmp_path / "f.png", png_bytes(samples, color, depth, palette, trns,
                                               filters=filters))
    for size in ((31, 17), (40, 11)):
        assert_same_as_libpng([path], size, libpng)


@pytest.mark.parametrize("kind", ["rgba8", "grey1", "pal4_trns", "rgb16_trns"])
@pytest.mark.parametrize("wh", [(3, 2), (1, 1), (2, 1), (1, 5), (7, 7), (9, 3)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_adam7_below_one_block_matches_libpng(wh, kind, tmp_path, libpng):
    # passes with no columns or no rows carry no filter bytes
    samples, color, depth, palette, trns = make_image(kind, *wh)
    path = write(tmp_path / "a.png", png_bytes(samples, color, depth, palette, trns,
                                               interlace=True, filters="mixed"))
    assert_same_as_libpng([path], wh, libpng)
    assert_same_as_libpng([path], (5, 4), libpng)


STREAMS = {"stored": (0, zlib.Z_DEFAULT_STRATEGY), "fixed": (6, zlib.Z_FIXED),
           "dynamic": (9, zlib.Z_DEFAULT_STRATEGY), "huffman_only": (6, zlib.Z_HUFFMAN_ONLY),
           "rle": (6, zlib.Z_RLE)}


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("kind", ["rgba8", "pal2"])
def test_each_deflate_block_type_matches_libpng(kind, stream, tmp_path, libpng):
    level, strategy = STREAMS[stream]
    samples, color, depth, palette, trns = make_image(kind, 64, 48)
    samples[:, 20:40] = samples[:1, 20:40]              # long matches too
    path = write(tmp_path / "s.png", png_bytes(samples, color, depth, palette, trns,
                                               filters="mixed", level=level,
                                               strategy=strategy))
    assert_same_as_libpng([path], (64, 48), libpng)


@pytest.mark.parametrize("interlace", [False, True], ids=["progressive", "adam7"])
def test_idat_split_into_one_byte_chunks_and_ancillary_chunks(interlace, tmp_path, libpng):
    # a deflate code straddles every chunk boundary
    samples, color, depth, palette, trns = make_image("pal4_trns", W, H)
    paths = [write(tmp_path / "split.png", png_bytes(samples, color, depth, palette, trns,
                                                     interlace, "mixed", idat_size=1)),
             write(tmp_path / "ancillary.png", png_bytes(samples, color, depth, palette, trns,
                                                         interlace, "mixed", ancillary=True))]
    assert_same_as_libpng(paths, (W, H), libpng)
    assert_same_as_libpng(paths, SIZES["resized"], libpng)


def test_an_800x800_rgba_image_matches_libpng(tmp_path, libpng):
    samples, color, depth, _, _ = make_image("rgba8", 800, 800)
    samples[200:600, 200:600] //= 7                      # something to match, too
    path = write(tmp_path / "big.png", png_bytes(samples, color, depth, filters="mixed"))
    assert_same_as_libpng([path], (800, 800), libpng)
    assert_same_as_libpng([path], (400, 300), libpng)


@settings(max_examples=60, deadline=None)
@given(w=st.integers(1, 40), h=st.integers(1, 40), kind=st.sampled_from(KINDS),
       filters=st.sampled_from([0, 1, 2, 3, 4, "mixed"]), level=st.integers(0, 9),
       interlace=st.booleans(), seed=st.integers(0, 2**16))
def test_hypothesis_matches_libpng(libpng, w, h, kind, filters, level, interlace, seed):
    samples, color, depth, palette, trns = make_image(kind, w, h, seed)
    with tempfile.TemporaryDirectory() as d:
        path = write(Path(d) / "h.png", png_bytes(samples, color, depth, palette, trns,
                                                  interlace, filters, level))
        failures, ref = libpng([path], (w, h))
        assert failures == 0
        np.testing.assert_array_equal(runtime.decode_png_batch([path], (w, h), n_threads=1),
                                      ref)


def _good() -> bytes:
    samples, color, depth, _, _ = make_image("rgba8", W, H)
    return png_bytes(samples, color, depth, filters="mixed")


def _chunks(data: bytes):
    """``[(offset, kind, length)]`` of a PNG's chunks."""
    out, pos = [], 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((pos, data[pos + 4:pos + 8], n))
        pos += 12 + n
    return out


def _at(data: bytes, kind: bytes):
    return next((pos, n) for pos, k, n in _chunks(data) if k == kind)


def _flip(data: bytes, offset: int) -> bytes:
    return data[:offset] + bytes([data[offset] ^ 0x01]) + data[offset + 1:]


def _with_ihdr(width: int, height: int) -> bytes:
    good = _good()
    pos, n = _at(good, b"IHDR")
    ihdr = chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0))
    return good[:pos] + ihdr + good[pos + 12 + n:]


def _bad_adler() -> bytes:
    good = _good()
    pos, n = _at(good, b"IDAT")
    data = good[pos + 8:pos + 8 + n]
    data = data[:-4] + struct.pack(">I", (struct.unpack(">I", data[-4:])[0] + 1) & 0xFFFFFFFF)
    return good[:pos] + chunk(b"IDAT", data) + good[pos + 12 + n:]


def _filter_5() -> bytes:
    samples, color, depth, _, _ = make_image("rgba8", W, H)
    rows = filter_rows(pack_rows(samples, depth), 4, [0] * H)
    rows[3, 0] = 5
    return png_bytes(samples, color, depth, stream=rows.tobytes())


def _unknown_critical() -> bytes:
    good = _good()
    pos, _ = _at(good, b"IDAT")
    return good[:pos] + chunk(b"CRIt", b"must be understood") + good[pos:]


CORRUPT = {
    "bad_signature": lambda: _flip(_good(), 1),
    "ihdr_crc": lambda: _flip(_good(), _at(_good(), b"IHDR")[0] + 8 + 13),
    "idat_crc": lambda: _flip(_good(), sum(_at(_good(), b"IDAT")) + 8),
    "adler32": _bad_adler,
    "truncated_idat": lambda: _good()[:_at(_good(), b"IDAT")[0] + 8
                                      + _at(_good(), b"IDAT")[1] // 2],
    "filter_byte_5": _filter_5,
    "unknown_critical_chunk": _unknown_critical,
    "width_0": lambda: _with_ihdr(0, H),
    "width_2000000": lambda: _with_ihdr(2_000_000, 1),
}


@pytest.mark.parametrize("case", CORRUPT)
def test_corrupt_files_raise_naming_the_file_as_libpng_refuses_them(case, tmp_path, libpng):
    good = write(tmp_path / "good.png", _good())
    bad = write(tmp_path / f"{case}.png", CORRUPT[case]())
    assert libpng([bad], (W, H))[0] == 1, "libpng accepts it"
    with pytest.raises(RuntimeError, match="1 of 2 PNGs") as e:
        runtime.decode_png_batch([good, bad], (W, H))
    assert str(bad) in str(e.value) and str(good) not in str(e.value)
    # and the good file still decodes as libpng does
    assert_same_as_libpng([good], (W, H), libpng)


def test_the_decoder_includes_no_png_or_zlib_header_and_links_nothing():
    source = runtime.PNG_SOURCE.read_text()
    assert not re.search(r"#\s*include\s*[<\"](png|zlib)\.h", source)
    assert runtime.LIBRARIES["nerf_png"] == (runtime.PNG_SOURCE, ("-ffp-contract=off",), ())
    assert runtime.library_path("nerf_png").name.startswith("libnerf_png-")
