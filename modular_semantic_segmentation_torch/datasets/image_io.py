"""PNG and JPEG reading, and PNG writing, without cv2: the subset of
``cv2.imread`` and ``cv2.imwrite`` that the dataset drivers use.

The JAX package's drivers read every image with ``cv2.imread``, which the
GPU machine does not have. :func:`imread` chooses the format from the
file's signature, as cv2 does, not from its name: ``\\x89PNG`` or
``FF D8 FF`` (the JAX package's own tests write PNG bytes under ``.jpg``
names, and cv2 reads them). A file in any other format raises
``ValueError``.

PNG: this module parses the container with the standard library
(``struct``, ``zlib``), reconstructs the filtered rows in the native host
library (``native_backend.png_unfilter``; the plain version
:func:`unfilter_plain` beside it is what the tests hold it against), and
converts the samples as cv2 (OpenCV 5 on libpng) does:

* ``IMREAD_COLOR`` (the default): three channels in BGR order; 16-bit
  samples reduced to 8 by their high byte; gray replicated; alpha dropped;
  palette expanded;
* ``IMREAD_GRAYSCALE`` and ``IMREAD_ANYDEPTH`` without a colour flag: one
  channel; a colour file is converted to gray by libpng's
  ``png_set_rgb_to_gray(0.299, 0.587)``, whose integer coefficients are
  9797, 19234 and 3737 over 2**15: truncated at 8 bits, rounded at 16
  bits (then reduced to 8 unless ``IMREAD_ANYDEPTH``);
* ``IMREAD_ANYDEPTH``: 16-bit samples stay 16-bit (big-endian in the
  file);
* ``IMREAD_ANYCOLOR``: three channels where the file has more than one,
  else one.

Supported PNG files: 8- and 16-bit gray, gray with alpha, RGB and RGBA,
and 8-bit palette, not interlaced. Adam7 interlacing and bit depths below
8 raise ``ValueError``; ancillary chunks (gamma, transparency, text, and
``eXIf``: a PNG's EXIF orientation is not applied) are ignored.

JPEG: the native decoder (``native/jpeg_decode.cc``, through
``native_backend.jpeg_decode``) computes what libjpeg-turbo 3.1 computes
under cv2 (accurate integer IDCT, fancy upsampling, libjpeg's fixed-point
colour tables), bit for bit, for baseline, extended and progressive
Huffman files with one or three components, any integral sampling and
restart intervals. The flags map as cv2 maps them for an 8-bit JPEG:

* a colour flag (``IMREAD_COLOR``) gives BGR, a gray file replicated;
* ``IMREAD_GRAYSCALE`` gives libjpeg's gray (the Y component of a YCbCr
  file; jdcolor.c's rgb-to-gray of an RGB file);
* ``IMREAD_ANYCOLOR`` gives one channel for a gray file, three for a
  colour one; ``IMREAD_ANYDEPTH`` changes nothing;
* the EXIF orientation (tag 0x0112 of the first ``Exif`` APP1 segment) is
  applied as cv2's ``ApplyExifOrientation`` applies it: 2 flips left to
  right, 3 rotates by 180 degrees, 4 flips top to bottom, 5 transposes, 6
  transposes and flips left to right, 7 transposes and rotates by 180, 8
  transposes and flips top to bottom.

Arithmetic-coded, lossless, 12-bit and 4-component (CMYK / YCCK) JPEG
files raise ``ValueError``, as do truncated or corrupt ones, where cv2
warns ("Premature end of JPEG file") and fills the missing blocks.

For either format, flags outside 0-6 (``IMREAD_UNCHANGED`` among them)
raise ``ValueError``, and a missing file gives None, as ``cv2.imread``
does, for the drivers' ``is None`` checks.

:func:`imwrite` writes PNG with filter type 0 with zlib; its bytes differ
from cv2's, its pixels read back equal in cv2 and here.
"""

import struct
import zlib

import numpy as np

from modular_semantic_segmentation_torch.datasets import native_backend

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1
IMREAD_ANYDEPTH = 2
IMREAD_ANYCOLOR = 4

# the flags held against cv2.imread (IMREAD_COLOR | IMREAD_ANYDEPTH |
# IMREAD_ANYCOLOR, 7, keeps the file's channels in cv2 and is refused)
_FLAGS = frozenset(range(7))

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's rgb_to_gray coefficients for (0.299, 0.587) over 2**15
_GRAY_R, _GRAY_G, _GRAY_B = 9797, 19234, 3737


def read_png(data):
    """(header dict, palette or None, inflated image data) of a PNG file's
    bytes; raises ValueError for what this module does not read."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (signature mismatch)")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            (width, height, bit_depth, color_type, _, _,
             interlace) = struct.unpack(">IIBBBBB", body)
            header = {"width": width, "height": height,
                      "bit_depth": bit_depth, "color_type": color_type,
                      "interlace": interlace}
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    if header["color_type"] not in _CHANNELS:
        raise ValueError(f"PNG colour type {header['color_type']} is invalid")
    if header["interlace"]:
        raise ValueError("Adam7-interlaced PNG files are not supported")
    if header["bit_depth"] not in (8, 16) or (
            header["color_type"] == 3 and header["bit_depth"] != 8):
        raise ValueError(f"PNG bit depth {header['bit_depth']} (colour type "
                         f"{header['color_type']}) is not supported: only 8 "
                         "and 16 bits, 8 for a palette")
    if header["color_type"] == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    return header, palette, zlib.decompress(b"".join(idat))


def unfilter_plain(raw, height, rowbytes, bpp):
    """The plain version of ``native_backend.png_unfilter``, byte by byte
    as the PNG specification writes the five filters."""
    src = np.frombuffer(raw, np.uint8).reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = [0] * rowbytes
    for y in range(height):
        kind, line = int(src[y, 0]), [int(v) for v in src[y, 1:]]
        row = [0] * rowbytes
        for i in range(rowbytes):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            elif kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"PNG row {y} has filter type {kind}, not "
                                 "0-4")
            row[i] = (line[i] + pred) & 0xFF
        out[y] = row
        prev = row
    return out


def decode_png(data):
    """The samples of a PNG file's bytes as [H, W, C] in the file's order
    (gray, gray + alpha, RGB or RGBA; a palette expanded to RGB), uint8 or
    uint16, and the colour type."""
    header, palette, raw = read_png(data)
    height, width = header["height"], header["width"]
    channels = _CHANNELS[header["color_type"]]
    sample_bytes = header["bit_depth"] // 8
    bpp = channels * sample_bytes
    rows = native_backend.png_unfilter(raw, height, width * bpp, bpp)
    if sample_bytes == 2:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    samples = samples.reshape(height, width, channels)
    if header["color_type"] == 3:
        index = samples[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        samples = palette[index]
    return samples, header["color_type"]


def _to_gray(rgb):
    """libpng's rgb_to_gray of [H, W, 3] RGB samples."""
    # at most 2**15 * 65535 + 2**14: fits in uint32
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    total = _GRAY_R * r + _GRAY_G * g + _GRAY_B * b
    if rgb.dtype == np.uint16:
        return ((total + (1 << 14)) >> 15).astype(np.uint16)
    return (total >> 15).astype(np.uint8)


def apply_exif_orientation(img, orientation):
    """``img`` ([H, W] or [H, W, C]) turned as cv2's ``ExifTransform``
    turns it for an EXIF orientation of 1-8; any other value leaves it."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _wants_color(flags, file_channels):
    return bool(flags & IMREAD_COLOR) or (
        bool(flags & IMREAD_ANYCOLOR) and file_channels > 1)


def decode_jpeg(data, flags=IMREAD_COLOR):
    """``cv2.imdecode`` of a JPEG file's bytes for flags 0-6 (see the
    module docstring)."""
    _, _, components, _ = native_backend.jpeg_header(data)
    gray = not _wants_color(flags, components)
    pixels, orientation = native_backend.jpeg_decode(data, gray=gray)
    return apply_exif_orientation(pixels, orientation)


def imread(path, flags=IMREAD_COLOR):
    """``cv2.imread(path, flags)`` for PNG and JPEG files, told apart by
    their signature (see the module docstring); None when the file cannot
    be opened."""
    if flags not in _FLAGS:
        raise ValueError(f"imread flags {flags} are not supported (only "
                         f"{sorted(_FLAGS)}; IMREAD_UNCHANGED is not)")
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(JPEG_SIGNATURE):
        return decode_jpeg(data, flags)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG or JPEG file (signature "
                         "mismatch)")
    samples, color_type = decode_png(data)
    # cv2's channel count for the file: 4 with alpha (gray + alpha too),
    # 3 for RGB and palette, 1 for gray
    file_channels = {0: 1, 2: 3, 3: 3, 4: 4, 6: 4}[color_type]
    if _wants_color(flags, file_channels):
        if samples.shape[-1] <= 2:  # gray (+ alpha): replicate the gray
            out = np.repeat(samples[..., :1], 3, axis=-1)
        else:  # RGB(A) -> BGR, alpha dropped
            out = np.ascontiguousarray(samples[..., 2::-1])
    elif samples.shape[-1] <= 2:
        out = np.ascontiguousarray(samples[..., 0])
    else:
        out = _to_gray(samples[..., :3])
    if out.dtype == np.uint16 and not flags & IMREAD_ANYDEPTH:
        out = (out >> 8).astype(np.uint8)
    return out


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def imwrite(path, img):
    """Write a uint8 or uint16 image as PNG, as ``cv2.imwrite`` takes it:
    [H, W] or [H, W, 1] gray, [H, W, 3] BGR, [H, W, 4] BGRA. Filter type
    0, zlib level 1 (cv2's default level). Returns True."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"imwrite takes uint8 or uint16 images, not "
                        f"{img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type, samples = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        color_type = 2 if img.shape[2] == 3 else 6
        samples = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=-1)
    else:
        raise ValueError(f"imwrite cannot write an image of shape "
                         f"{img.shape}")
    height, width, channels = samples.shape
    if img.dtype == np.uint16:
        samples = samples.astype(">u2")
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(height, -1)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), rows], 1)
    header = struct.pack(">IIBBBBB", width, height,
                         8 * img.dtype.itemsize, color_type, 0, 0, 0)
    data = (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return True
