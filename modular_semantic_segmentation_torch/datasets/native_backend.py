"""ctypes bridge to the port's native host library (``native/host_ops.cc``
and ``native/jpeg_decode.cc``).

The counterpart of the JAX package's ``datasets/native_backend.py``: image
resize, LUT mapping and the uint8 -> float32 batch pack in C++, plus the
PNG row unfilter and the JPEG decoder of ``datasets/image_io.py``. The
library is compiled with the host's C++ compiler on first use,

    g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17
        -o _build/host_ops-<hash>.so native/host_ops.cc native/jpeg_decode.cc

into ``modular_semantic_segmentation_torch/_build/`` (not committed), under
a name that carries a hash of the sources and the flags, so an edited
source is rebuilt. A failed build raises.

Unlike the JAX package's bridge, no entry point returns None for the
caller to fall back to cv2 (there is none on the GPU machine): each one
takes the dtypes and layouts it names and raises for any other, and the
callers dispatch by dtype to it or to a named numpy path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "native", "host_ops.cc")
JPEG_SOURCE = os.path.join(_PACKAGE_DIR, "native", "jpeg_decode.cc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
# no -fopenmp: the GPU machine's g++ has no OpenMP runtime (libgomp); the
# loader's threads run the calls side by side instead
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

#: cv2's interpolation codes, which the callers pass as the JAX package's
#: code passes cv2's
INTER_NEAREST = 0
INTER_LINEAR = 1

_LOCK = threading.Lock()
_LIB = None

_SIGNATURES = {
    "resize_bilinear_u8": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double],
    "resize_nearest": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double],
    "apply_lut_u8": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p],
    "pack_normalize_f32": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p],
    "png_unfilter": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p],
    "jpeg_header": [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int],
    "jpeg_decode": [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int],
}
_RETURNS_STATUS = ("png_unfilter", "jpeg_header", "jpeg_decode")


def library_path():
    """Path of the built library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for source in (SOURCE, JPEG_SOURCE):
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"host_ops-{digest.hexdigest()[:16]}.so")


def build(timeout=300):
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++ on PATH, or $CXX) "
                           "to build the native host library")
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = f"{target}.{os.getpid()}.{threading.get_ident()}.part"
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", partial, SOURCE,
                              JPEG_SOURCE],
                             capture_output=True, text=True, timeout=timeout)
        if out.returncode != 0:
            raise RuntimeError(f"building the native host library failed (exit "
                               f"{out.returncode}):\n{out.stdout}{out.stderr}")
        os.replace(partial, target)
    finally:
        if os.path.exists(partial):
            os.remove(partial)
    return target


def _lib():
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int if name in _RETURNS_STATUS \
                        else None
                _LIB = lib
    return _LIB


def resize(img, fx=None, fy=None, interpolation=INTER_LINEAR, dsize=None):
    """``cv2.resize(img, dsize, fx=fx, fy=fy, interpolation=...)`` with the
    JAX package's native ops: INTER_LINEAR on uint8 (float weights; within
    one uint8 step of cv2's fixed-point weights) and INTER_NEAREST on any
    dtype of 1, 2, 4 or 8 bytes (exact). ``dsize`` = (width, height) sets
    the output size and the factors as cv2 derives them from it. The
    output keeps a trailing channel axis of 1, as the JAX package's native
    resize does."""
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes [H, W] or [H, W, C], not "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if dsize is not None:
        out_w, out_h = int(dsize[0]), int(dsize[1])
        fx, fy = out_w / w, out_h / h
    else:
        out_h, out_w = int(round(h * fy)), int(round(w * fx))
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize of {img.shape} by ({fy}, {fx}) is empty")
    c = img.shape[2] if img.ndim == 3 else 1
    # the sampling scale is 1/f, in double, as cv2 keeps it when called
    # with fx/fy
    scale_y, scale_x = 1.0 / fy, 1.0 / fx
    src = np.ascontiguousarray(img)
    dst = np.empty((out_h, out_w) + img.shape[2:], img.dtype)
    if interpolation == INTER_LINEAR:
        if img.dtype != np.uint8:
            raise NotImplementedError(
                f"bilinear resize of {img.dtype} images is not supported "
                "(only uint8)")
        _lib().resize_bilinear_u8(src.ctypes.data, h, w, c, dst.ctypes.data,
                                  out_h, out_w, scale_y, scale_x)
    elif interpolation == INTER_NEAREST:
        if img.dtype.itemsize not in (1, 2, 4, 8):
            raise NotImplementedError(f"nearest resize of {img.dtype}")
        _lib().resize_nearest(src.ctypes.data, h, w, c, img.dtype.itemsize,
                              dst.ctypes.data, out_h, out_w, scale_y,
                              scale_x)
    else:
        raise ValueError(f"unknown interpolation {interpolation}")
    return dst


def apply_lut(img, lut):
    """``lut[img]`` for a uint8 image and a 256-entry uint8 LUT."""
    if img.dtype != np.uint8:
        raise TypeError(f"apply_lut takes uint8 images, not {img.dtype}")
    src = np.ascontiguousarray(img)
    dst = np.empty_like(src)
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"the LUT has shape {lut.shape}, not (256,)")
    _lib().apply_lut_u8(src.ctypes.data, src.size, lut.ctypes.data,
                        dst.ctypes.data)
    return dst


def pack_normalize(img_u8, scale=1.0, offset=0.0):
    """uint8 -> float32 ``img * scale + offset`` in one native pass (the
    batch pack); the same values as numpy's float32 multiply then add."""
    if img_u8.dtype != np.uint8:
        raise TypeError(f"pack_normalize takes uint8, not {img_u8.dtype}")
    src = np.ascontiguousarray(img_u8)
    dst = np.empty(src.shape, np.float32)
    _lib().pack_normalize_f32(src.ctypes.data, src.size, scale, offset,
                              dst.ctypes.data)
    return dst


def png_unfilter(raw, height, rowbytes, bpp):
    """Reconstruct PNG image bytes: ``raw`` holds ``height`` rows of a
    filter-type byte and ``rowbytes`` filtered bytes; returns the
    ``[height, rowbytes]`` uint8 array. Raises on a filter type outside
    0-4."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (rowbytes + 1):
        raise ValueError(f"PNG image data has {src.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    dst = np.empty((height, rowbytes), np.uint8)
    status = _lib().png_unfilter(src.ctypes.data, height, rowbytes, bpp,
                                 dst.ctypes.data)
    if status:
        raise ValueError(f"PNG row {status - 1} has filter type "
                         f"{src[(status - 1) * (rowbytes + 1)]}, not 0-4")
    return dst


#: the JPEG decoder's status codes (native/jpeg_decode.cc)
JPEG_ERRORS = {1: "corrupt or truncated JPEG", 2: "unsupported JPEG",
               3: "out of memory decoding JPEG"}


def _jpeg_status(status, err):
    if status:
        raise ValueError(f"{JPEG_ERRORS.get(status, 'JPEG error')}: "
                         f"{err.value.decode(errors='replace')}")


def jpeg_header(data):
    """(height, width, components, EXIF orientation) of a JPEG file's bytes,
    from its markers up to the first scan; the orientation is 0 where the
    file has no EXIF orientation tag. Raises ValueError for what the
    decoder does not read."""
    data = bytes(data)
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(256)
    _jpeg_status(_lib().jpeg_header(data, len(data), info.ctypes.data, err,
                                    len(err)), err)
    return tuple(int(v) for v in info)


def jpeg_decode(data, gray=False):
    """Decode a JPEG file's bytes as ``cv2.imread`` (libjpeg-turbo) does:
    a uint8 ``[H, W, 3]`` BGR array, or ``[H, W]`` libjpeg gray when
    ``gray``, in the file's stored orientation; returns ``(pixels,
    orientation)`` with the EXIF orientation (1-8, 0 where there is none)
    for the caller to apply. Raises ValueError with the decoder's reason
    for corrupt, truncated or unsupported files."""
    data = bytes(data)
    height, width, _, orientation = jpeg_header(data)
    out = np.empty((height, width) if gray else (height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    _jpeg_status(_lib().jpeg_decode(data, len(data), int(bool(gray)),
                                    out.ctypes.data, out.size, err,
                                    len(err)), err)
    return out, orientation
