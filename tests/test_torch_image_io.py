"""The port's PNG reader and writer (``datasets/image_io``) against cv2.

``imread`` must equal ``cv2.imread`` value for value, with its shape and
dtype, for every flag the dataset drivers pass (the default
``IMREAD_COLOR``, ``IMREAD_ANYDEPTH`` and ``IMREAD_ANYDEPTH |
IMREAD_ANYCOLOR``) and the other flags it takes, on 8- and 16-bit gray,
RGB and RGBA files that cv2 wrote with its adaptive filters (all five
filter types occur, asserted), and on palette and gray + alpha files
written here. Files the port writes read back equal in cv2. The native
unfilter equals its plain version, and the refused cases raise.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from modular_semantic_segmentation_torch.datasets import (
    image_io, native_backend)

H, W = 37, 53
DRIVER_FLAGS = [cv2.IMREAD_COLOR, cv2.IMREAD_ANYDEPTH,
                cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR]
OTHER_FLAGS = [cv2.IMREAD_GRAYSCALE, cv2.IMREAD_ANYCOLOR,
               cv2.IMREAD_COLOR | cv2.IMREAD_ANYDEPTH,
               cv2.IMREAD_COLOR | cv2.IMREAD_ANYCOLOR]


def _plane(dtype, seed):
    """Bands of a gradient, of noise and of constant rows, so that
    libpng's adaptive filtering picks every filter type."""
    rng = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    yy, xx = np.mgrid[:H, :W]
    smooth = (xx * 3 + yy * 2 + seed) * (top // 255) % (top + 1)
    noise = rng.randint(0, top + 1, (H, W))
    rows = (yy * 7 * (top // 255)) % (top + 1)
    band = (yy // 5) % 3
    return np.where(band == 0, smooth,
                    np.where(band == 1, noise, rows)).astype(dtype)


def _image(dtype, channels):
    if channels == 1:
        return _plane(dtype, 1)
    return np.stack([_plane(dtype, s) for s in range(channels)], -1)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_raw(path, bit_depth, color_type, rows, palette=None,
               filters=None, interlace=0):
    """A PNG from raw sample rows (bytes each), filter type 0 unless
    ``filters`` gives the already filtered rows' types."""
    height, width = len(rows), None
    raw = b"".join(bytes([filters[i] if filters else 0]) + row
                   for i, row in enumerate(rows))
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    width = len(rows[0]) * 8 // (bit_depth * channels)
    data = (image_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, bit_depth, color_type, 0, 0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", palette.tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _filter_types(path):
    with open(path, "rb") as f:
        header, _, raw = image_io.read_png(f.read())
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[header["color_type"]]
    rowbytes = header["width"] * channels * header["bit_depth"] // 8
    return set(np.frombuffer(raw, np.uint8)[::rowbytes + 1].tolist())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path} of cv2-written files (adaptive filters) and of the
    palette and gray + alpha files written here."""
    base = tmp_path_factory.mktemp("png")
    out = {}
    for dtype in (np.uint8, np.uint16):
        for channels in (1, 3, 4):
            path = str(base / f"cv2_{dtype.__name__}_{channels}.png")
            # an explicit compression level turns on libpng's adaptive
            # filtering (cv2's default writes Sub rows only)
            assert cv2.imwrite(path, _image(dtype, channels),
                               [cv2.IMWRITE_PNG_COMPRESSION, 3])
            out[path] = path
    rng = np.random.RandomState(2)
    palette = rng.randint(0, 256, (200, 3)).astype(np.uint8)
    index = rng.randint(0, 200, (H, W)).astype(np.uint8)
    out["palette"] = str(base / "palette.png")
    _write_raw(out["palette"], 8, 3, [r.tobytes() for r in index], palette)
    gray_alpha = rng.randint(0, 256, (H, W, 2)).astype(np.uint8)
    out["gray_alpha"] = str(base / "gray_alpha.png")
    _write_raw(out["gray_alpha"], 8, 4,
               [r.tobytes() for r in gray_alpha])
    gray_alpha16 = rng.randint(0, 65536, (H, W, 2)).astype(">u2")
    out["gray_alpha16"] = str(base / "gray_alpha16.png")
    _write_raw(out["gray_alpha16"], 16, 4,
               [r.tobytes() for r in gray_alpha16])
    return out


def test_cv2_files_hold_every_filter_type(files):
    seen = set()
    for path in files.values():
        if os.path.basename(path).startswith("cv2_"):
            seen |= _filter_types(path)
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("flags", DRIVER_FLAGS + OTHER_FLAGS)
def test_imread_matches_cv2(files, flags):
    for name, path in files.items():
        want = cv2.imread(path, flags)
        got = image_io.imread(path, flags)
        assert got.shape == want.shape, (name, flags)
        assert got.dtype == want.dtype, (name, flags)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {flags}")


def test_imread_of_every_color_converts_to_gray_as_cv2(tmp_path):
    """All 2**24 8-bit colours in one file, and random 16-bit colours:
    libpng's rgb_to_gray, truncated at 8 bits and rounded at 16."""
    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    path = str(tmp_path / "colors.png")
    cv2.imwrite(path, bgr)
    for flags in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_ANYDEPTH):
        np.testing.assert_array_equal(image_io.imread(path, flags),
                                      cv2.imread(path, flags))
    colors16 = np.random.RandomState(3).randint(
        0, 65536, (512, 512, 3)).astype(np.uint16)
    path = str(tmp_path / "colors16.png")
    cv2.imwrite(path, colors16)
    for flags in (cv2.IMREAD_GRAYSCALE, cv2.IMREAD_ANYDEPTH):
        np.testing.assert_array_equal(image_io.imread(path, flags),
                                      cv2.imread(path, flags))


def test_missing_file_gives_none(tmp_path):
    for flags in DRIVER_FLAGS:
        assert image_io.imread(str(tmp_path / "missing.png"), flags) is None


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(H, W), (H, W, 1), (H, W, 3),
                                   (H, W, 4)])
def test_port_written_files_read_back_in_cv2(tmp_path, dtype, shape):
    rng = np.random.RandomState(4)
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "port.png")
    assert image_io.imwrite(path, img)
    want = img[..., 0] if len(shape) == 3 and shape[2] == 1 else img
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                  want)
    np.testing.assert_array_equal(
        image_io.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR),
        cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_plain(bpp):
    """Random filtered rows of every filter type (the first row too, whose
    'up' is zero), against the byte-by-byte plain version."""
    rng = np.random.RandomState(bpp)
    height, rowbytes = 9, bpp * 7
    types = np.concatenate([[4, 3], rng.randint(0, 5, height - 2)])
    rows = rng.randint(0, 256, (height, rowbytes)).astype(np.uint8)
    raw = np.concatenate([types[:, None].astype(np.uint8), rows],
                         1).tobytes()
    got = native_backend.png_unfilter(raw, height, rowbytes, bpp)
    want = image_io.unfilter_plain(raw, height, rowbytes, bpp)
    np.testing.assert_array_equal(got, want)


def test_native_unfilter_equals_plain_on_cv2_files(files):
    for path in files.values():
        with open(path, "rb") as f:
            header, _, raw = image_io.read_png(f.read())
        channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[header["color_type"]]
        bpp = channels * header["bit_depth"] // 8
        rowbytes = header["width"] * bpp
        np.testing.assert_array_equal(
            native_backend.png_unfilter(raw, header["height"], rowbytes,
                                        bpp),
            image_io.unfilter_plain(raw, header["height"], rowbytes, bpp))


def test_refused_files_and_flags(tmp_path):
    rows = [bytes(W)] * 4
    path = str(tmp_path / "x.png")
    _write_raw(path, 8, 0, rows, interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        image_io.imread(path)
    _write_raw(path, 4, 0, [bytes(W // 2)] * 4)
    with pytest.raises(ValueError, match="bit depth 4"):
        image_io.imread(path)
    _write_raw(path, 8, 0, rows, filters=[0, 5, 0, 0])
    with pytest.raises(ValueError, match="filter type 5"):
        image_io.imread(path)
    _write_raw(path, 8, 0, rows)
    for flags in (cv2.IMREAD_UNCHANGED, 7):
        with pytest.raises(ValueError, match="flags"):
            image_io.imread(path, flags)
    with open(path, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.imread(path)
