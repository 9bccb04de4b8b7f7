"""The port's JPEG decoder (``native/jpeg_decode.cc`` through
``datasets/image_io.imread``) against ``cv2.imread`` / ``cv2.imdecode``
(libjpeg-turbo), on the CPU: bit for bit, with no tolerance.

* every fixture of ``tests/data/jpeg/`` for flags 0-6, and the manifest's
  digests, which still equal cv2's output here (so that a fixture that
  drifts is caught), and which the GPU machine holds the decoder to;
* JPEGs encoded on the fly with seeded content: every sampling factor
  cv2 writes, baseline, progressive, optimised tables, restart intervals,
  gray, odd sizes, quality 50 and 95;
* EXIF orientations 1-8 in either byte order, and libjpeg's colour-space
  rule (JFIF, Adobe APP14, bare files, component ids), and files without
  a DHT segment (the standard tables);
* refused inputs raise ``ValueError`` and never crash: truncation at every
  marker boundary and inside the entropy data, seeded byte flips, 12-bit,
  arithmetic, lossless and CMYK frames, an incomplete progressive file;
* the format is chosen by signature, not by name; a PNG's ``eXIf``
  orientation stays ignored.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from modular_semantic_segmentation_torch.datasets import (
    image_io, native_backend)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
sys.path.insert(0, FIXTURES)
import make_fixtures  # noqa: E402

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]

FLAGS = range(7)
SAMPLINGS = tuple(make_fixtures.SAMPLING)
SIZES = ((1, 1), (2, 3), (7, 13), (17, 33), (40, 24), (9, 2))


def _digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data, flags):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flags)


def _assert_matches_cv2(data, what, flags=FLAGS):
    for f in flags:
        want = _cv2(data, f)
        got = image_io.decode_jpeg(data, f)
        assert got.dtype == np.uint8, (what, f)
        assert got.shape == want.shape, (what, f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} flags {f}")


def _segments(data):
    """[(marker, bytes)] of a JPEG up to and including the first SOS
    segment, whose bytes run to the end of the file."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            out.append((marker, data[pos:]))
            break
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos:pos + 2 + length]))
        pos += 2 + length
    return out


def _join(segments):
    return b"\xff\xd8" + b"".join(s for _, s in segments)


def _marker_offsets(data):
    """Offsets of every marker of a file (SOI, each segment, SOS, RSTn in
    the entropy data, the scans of a progressive file, EOI)."""
    offsets = []
    for i in range(len(data) - 1):
        if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF):
            offsets.append(i)
    return offsets


# --------------------------------------------------------------- fixtures
@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_matches_cv2_and_manifest(name):
    path = os.path.join(FIXTURES, name)
    entry = MANIFEST[name]
    for f in FLAGS:
        want = cv2.imread(path, f)
        got = image_io.imread(path, f)
        assert got.shape == want.shape, (name, f)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} flags {f}")
    color = cv2.imread(path, cv2.IMREAD_COLOR)
    gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    # the manifest still records what cv2 decodes here
    assert list(color.shape) == entry["shape"]
    assert _digest(color) == entry["sha256_color"]
    assert _digest(gray) == entry["sha256_gray"]
    assert _digest(image_io.imread(path)) == entry["sha256_color"]
    assert _digest(image_io.imread(path, 0)) == entry["sha256_gray"]


def test_fixtures_are_the_generators():
    """The committed files are what the generator writes."""
    for name, data in make_fixtures.fixtures().items():
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == data, name
    assert sorted(make_fixtures.fixtures()) == sorted(MANIFEST)


# ------------------------------------------------------ the coding matrix
@pytest.mark.parametrize("mode", ["baseline", "progressive", "optimized",
                                  "restart1", "restart7"])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_encoded_matrix_matches_cv2(sampling, mode):
    seed = 1000 * SAMPLINGS.index(sampling) + len(mode)
    for i, (h, w) in enumerate(SIZES):
        for quality in (50, 95):
            img = make_fixtures.photograph(seed + i, h, w)
            data = make_fixtures.encode(
                img, quality, sampling, progressive=mode == "progressive",
                optimize=mode == "optimized",
                restart={"restart1": 1, "restart7": 7}.get(mode, 0))
            _assert_matches_cv2(data, f"{sampling} {mode} {h}x{w} "
                                      f"q{quality}")


@pytest.mark.parametrize("progressive", [False, True])
def test_gray_files_match_cv2(progressive):
    for i, (h, w) in enumerate(SIZES):
        img = make_fixtures.photograph(50 + i, h, w, channels=1)
        data = make_fixtures.encode(img, 80, progressive=progressive,
                                    restart=3 * progressive)
        _assert_matches_cv2(data, f"gray {h}x{w}")


def test_voc_sized_frames_match_cv2():
    """Frames of VOC's sizes with the default encoder settings (4:2:0,
    quality 95)."""
    for seed, (h, w) in enumerate(((375, 500), (500, 375), (333, 500))):
        img = make_fixtures.photograph(70 + seed, h, w)
        _assert_matches_cv2(cv2.imencode(".jpg", img)[1].tobytes(),
                            f"{h}x{w}", flags=(0, 1))


# ---------------------------------------------------- EXIF and colour space
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(orientation):
    img = make_fixtures.photograph(80 + orientation, 13, 21)
    for sampling in ("420", "444"):
        base = make_fixtures.encode(img, 90, sampling)
        for little in (True, False):
            data = make_fixtures.splice_after_app0(
                base, make_fixtures.exif_app1(orientation, little))
            assert native_backend.jpeg_header(data)[3] == orientation
            _assert_matches_cv2(data, f"orientation {orientation}")
    gray = make_fixtures.encode(img[..., 1], 90)
    _assert_matches_cv2(make_fixtures.splice_after_app0(
        gray, make_fixtures.exif_app1(orientation)), "gray")


def test_exif_variants_match_cv2():
    """Only the first ``Exif`` APP1 counts, an APP1 without the ``Exif``
    header is not EXIF, and an orientation outside 1-8 leaves the frame as
    it is."""
    base = make_fixtures.encode(make_fixtures.photograph(90, 11, 19), 90)
    first = make_fixtures.splice_after_app0(
        make_fixtures.splice_after_app0(base, make_fixtures.exif_app1(6)),
        make_fixtures.exif_app1(3))
    assert native_backend.jpeg_header(first)[3] == 3
    _assert_matches_cv2(first, "first APP1")
    bare = make_fixtures.exif_app1(6)
    length = int.from_bytes(bare[2:4], "big") - 6
    no_header = b"\xff\xe1" + struct.pack(">H", length) + bare[10:]
    data = make_fixtures.splice_after_app0(base, no_header)
    assert native_backend.jpeg_header(data)[3] == 0
    _assert_matches_cv2(data, "APP1 without Exif header")
    for orientation in (0, 9, 300):
        _assert_matches_cv2(make_fixtures.splice_after_app0(
            base, make_fixtures.exif_app1(orientation)), f"{orientation}")


def _with_ids(segments, ids):
    """The frame's and the scan's component ids replaced (3 components,
    one interleaved scan)."""
    out = []
    for marker, seg in segments:
        seg = bytearray(seg)
        if marker == 0xC0:
            for i in range(3):
                seg[10 + 3 * i] = ids[i]
        elif marker == 0xDA:
            for i in range(3):
                seg[5 + 2 * i] = ids[i]
        out.append((marker, bytes(seg)))
    return out


def _adobe(transform):
    return (0xEE, b"\xff\xee" + struct.pack(">H", 14) + b"Adobe"
            + bytes([0, 100, 0, 0, 0, 0, transform]))


@pytest.mark.parametrize("sampling", ["444", "420"])
def test_colour_space_rule_matches_cv2(sampling):
    data = make_fixtures.encode(make_fixtures.photograph(95, 19, 27), 90,
                                sampling)
    segments = _segments(data)
    bare = [s for s in segments if s[0] != 0xE0]
    variants = {
        "bare": bare,
        "bare RGB ids": _with_ids(bare, b"RGB"),
        "bare other ids": _with_ids(bare, b"abc"),
        "JFIF and RGB ids": _with_ids(segments, b"RGB"),
        "no DHT": [s for s in segments if s[0] != 0xC4],
    }
    for transform in (0, 1, 2):
        variants[f"Adobe {transform}"] = [_adobe(transform)] + bare
        variants[f"JFIF and Adobe {transform}"] = \
            segments[:1] + [_adobe(transform)] + segments[1:]
    for what, segs in variants.items():
        _assert_matches_cv2(_join(segs), what)


# ------------------------------------------------------- refused inputs
def _refused(data):
    """The decoder raises ValueError on ``data`` for every flag."""
    for f in (0, 1):
        with pytest.raises(ValueError):
            image_io.decode_jpeg(data, f)


def _decodes_or_raises(data):
    """Either pixels of the header's shape or ValueError; never a crash."""
    try:
        height, width, _, _ = native_backend.jpeg_header(data)
    except ValueError:
        return "raised"
    for gray in (False, True):
        try:
            pixels, _ = native_backend.jpeg_decode(data, gray=gray)
        except ValueError:
            return "raised"
        assert pixels.shape[:2] == (height, width)
    return "decoded"


@pytest.mark.parametrize("name", ["s420_q95.jpg", "progressive_420.jpg",
                                  "restart7_progressive.jpg", "gray.jpg",
                                  "restart1_420.jpg"])
def test_truncated_files_raise(name):
    """cv2 warns ("Premature end of JPEG file") and fills the missing
    blocks; the port raises, at every marker boundary and inside the
    entropy data."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    cuts = set(_marker_offsets(data))
    cuts |= {c + 1 for c in cuts} | {c + 2 for c in cuts}
    cuts |= set(range(0, len(data), max(1, len(data) // 40)))
    cuts |= {len(data) - 1, len(data) - 2}
    for cut in sorted(cuts):
        if cut < len(data):
            _refused(data[:cut])


@pytest.mark.parametrize("name", ["s420_q95.jpg", "progressive_420.jpg",
                                  "restart7_411.jpg", "gray.jpg"])
def test_corrupt_bytes_decode_or_raise(name):
    """A few hundred seeded byte flips in the headers and the entropy data:
    each decodes or raises ValueError."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    rs = np.random.RandomState(len(name))
    outcomes = {"raised": 0, "decoded": 0}
    for _ in range(150):
        corrupt = bytearray(data)
        for _ in range(rs.randint(1, 4)):
            corrupt[rs.randint(2, len(corrupt))] = rs.randint(0, 256)
        outcomes[_decodes_or_raises(bytes(corrupt))] += 1
    for _ in range(50):
        corrupt = bytearray(data)
        corrupt[rs.randint(2, len(corrupt))] ^= 1 << rs.randint(0, 8)
        outcomes[_decodes_or_raises(bytes(corrupt))] += 1
    assert outcomes["raised"] > 0


def _sof(data):
    for marker, seg in _segments(data):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker, seg
    raise AssertionError("no SOF")


@pytest.mark.parametrize("marker,why", [
    (0xC3, "lossless"), (0xC9, "arithmetic"), (0xCA, "arithmetic"),
    (0xCB, "lossless"), (0xC5, "hierarchical")])
def test_unsupported_frames_raise(marker, why):
    data = bytearray(make_fixtures.encode(
        make_fixtures.photograph(5, 16, 16), 90))
    pos = data.index(b"\xff\xc0")
    data[pos + 1] = marker
    with pytest.raises(ValueError, match="not supported"):
        image_io.decode_jpeg(bytes(data))


def test_12_bit_and_cmyk_frames_raise():
    data = make_fixtures.encode(make_fixtures.photograph(6, 16, 16), 90,
                                "444")
    marker, sof = _sof(data)
    twelve = bytearray(data)
    twelve[data.index(sof) + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        image_io.decode_jpeg(bytes(twelve))
    # a fourth component (CMYK / YCCK); the scan is never reached
    cmyk = bytearray(sof)
    cmyk[3] += 3
    cmyk[9] = 4
    cmyk += bytes([4, 0x11, 0])
    with pytest.raises(ValueError, match="4-component"):
        image_io.decode_jpeg(data.replace(sof, bytes(cmyk)))


def test_incomplete_progressive_file_raises():
    """A progressive file cut to its first scans (EOI kept): libjpeg smooths
    its blocks, the port refuses."""
    data = make_fixtures.encode(make_fixtures.photograph(7, 32, 32), 90,
                                progressive=True)
    scans = [i for i in _marker_offsets(data) if data[i + 1] == 0xDA]
    partial = data[:scans[2]] + b"\xff\xd9"
    assert _cv2(partial, 1) is not None
    with pytest.raises(ValueError, match="smooth"):
        image_io.decode_jpeg(partial)


def test_oversized_frame_is_refused_before_allocation():
    data = bytearray(make_fixtures.encode(
        make_fixtures.photograph(8, 16, 16), 90))
    marker, sof = _sof(bytes(data))
    pos = data.index(sof)
    data[pos + 5:pos + 9] = struct.pack(">HH", 65000, 65000)
    with pytest.raises(ValueError, match="more blocks"):
        native_backend.jpeg_header(bytes(data))


# -------------------------------------------------------- signature, PNG
def test_format_is_chosen_by_signature(tmp_path):
    img = make_fixtures.photograph(9, 15, 22)
    png_as_jpg = str(tmp_path / "png.jpg")
    jpg_as_png = str(tmp_path / "jpg.png")
    with open(png_as_jpg, "wb") as f:
        f.write(cv2.imencode(".png", img)[1].tobytes())
    with open(jpg_as_png, "wb") as f:
        f.write(cv2.imencode(".jpg", img)[1].tobytes())
    for path in (png_as_jpg, jpg_as_png):
        for f in FLAGS:
            np.testing.assert_array_equal(image_io.imread(path, f),
                                          cv2.imread(path, f))
    with open(str(tmp_path / "x.jpg"), "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG or JPEG"):
        image_io.imread(str(tmp_path / "x.jpg"))
    assert image_io.imread(str(tmp_path / "missing.jpg")) is None


def test_png_exif_orientation_is_ignored(tmp_path):
    """cv2 turns a PNG by its ``eXIf`` chunk; the port does not (a
    difference kept: no driver reads such a PNG)."""
    img = make_fixtures.photograph(10, 8, 12)
    png = cv2.imencode(".png", img)[1].tobytes()
    tiff = make_fixtures.exif_app1(6)[10:]
    chunk = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
             + struct.pack(">I", zlib.crc32(b"eXIf" + tiff)))
    end_of_ihdr = 8 + 25
    path = str(tmp_path / "exif.png")
    with open(path, "wb") as f:
        f.write(png[:end_of_ihdr] + chunk + png[end_of_ihdr:])
    np.testing.assert_array_equal(image_io.imread(path), img)
    np.testing.assert_array_equal(
        cv2.imread(path), image_io.apply_exif_orientation(img, 6))


def test_failed_jpeg_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "jpeg_decode.cc"
    broken.write_text("this is not C++ either\n")
    monkeypatch.setattr(native_backend, "JPEG_SOURCE", str(broken))
    monkeypatch.setattr(native_backend, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed"):
        native_backend.build()
