"""Write the JPEG fixtures of this directory and their manifest with cv2.

    python tests/data/jpeg/make_fixtures.py

Every frame is a seeded numpy "photograph" (gradients, edges, texture and
noise) encoded by ``cv2.imencode``; the EXIF cases have an APP1 segment
with one orientation entry spliced in after the JFIF APP0. The manifest
records, for each file, the shape and the sha256 of the pixels that
``cv2.imread`` decodes with ``IMREAD_COLOR`` and with
``IMREAD_GRAYSCALE``, so that a machine without cv2 can hold a decoder to
cv2's exact output (``tests/test_torch_jpeg.py`` checks that the digests
still equal cv2's output where cv2 is installed).
"""

import hashlib
import json
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
            "440": 0x121111, "411": 0x411111}


def photograph(seed, height, width, channels=3):
    """A seeded uint8 frame: smooth gradients, a few flat shapes with hard
    edges, a sinusoidal texture and mild noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.empty((height, width, channels))
    for c in range(channels):
        a, b, phase = rs.uniform(-1, 1), rs.uniform(-1, 1), rs.uniform(0, 6)
        img[..., c] = (128 + 60 * (a * x / max(width, 1) + b * y /
                                   max(height, 1))
                       + 20 * np.sin(x / 5.0 + phase) * np.cos(y / 7.0))
    for _ in range(6):
        y0, x0 = rs.randint(0, height), rs.randint(0, width)
        h, w = rs.randint(1, height // 3 + 2), rs.randint(1, width // 3 + 2)
        img[y0:y0 + h, x0:x0 + w] = rs.uniform(0, 255, channels)
    cy, cx, r = rs.uniform(0, height), rs.uniform(0, width), \
        rs.uniform(2, max(height, width) / 4 + 3)
    img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rs.uniform(0, 255, channels)
    img += rs.normal(0, 3, img.shape)
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def exif_app1(orientation, little_endian=True):
    """An APP1 segment holding an EXIF IFD0 with one orientation entry."""
    e = "<" if little_endian else ">"
    tiff = (b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
    entry = struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    body = (b"Exif\x00\x00" + tiff + struct.pack(e + "H", 1) + entry
            + struct.pack(e + "I", 0))
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def splice_after_app0(data, segment):
    """``segment`` inserted after the JFIF APP0 that cv2 writes first."""
    assert data[2:4] == b"\xff\xe0"
    end = 4 + int.from_bytes(data[4:6], "big")
    return data[:end] + segment + data[end:]


def encode(img, quality=95, sampling="420", progressive=False,
           optimize=False, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, data = cv2.imencode(".jpg", img, params)
    assert ok
    return data.tobytes()


def fixtures():
    """name -> (JPEG bytes, what it covers)."""
    out = {}
    seed = 100
    for sampling in SAMPLING:
        for quality in (50, 95):
            seed += 1
            out[f"s{sampling}_q{quality}.jpg"] = encode(
                photograph(seed, 17, 33), quality, sampling)
    out["progressive_420.jpg"] = encode(photograph(1, 33, 47), 90, "420",
                                        progressive=True)
    out["progressive_444.jpg"] = encode(photograph(2, 20, 29), 75, "444",
                                        progressive=True)
    out["optimized_422.jpg"] = encode(photograph(3, 31, 40), 85, "422",
                                      optimize=True)
    out["restart1_420.jpg"] = encode(photograph(4, 24, 40), 90, "420",
                                     restart=1)
    out["restart7_411.jpg"] = encode(photograph(5, 40, 72), 80, "411",
                                     restart=7)
    out["restart7_progressive.jpg"] = encode(photograph(6, 40, 56), 80,
                                             "420", progressive=True,
                                             restart=7)
    out["gray.jpg"] = encode(photograph(7, 29, 37, 1), 90)
    out["gray_progressive.jpg"] = encode(photograph(8, 19, 23, 1), 70,
                                         progressive=True)
    out["size1x1.jpg"] = encode(photograph(9, 1, 1), 95, "420")
    out["size7x13.jpg"] = encode(photograph(10, 7, 13), 95, "420")
    out["size17x33_440.jpg"] = encode(photograph(11, 17, 33), 90, "440")
    base = encode(photograph(12, 24, 40), 90, "420")
    for orientation in (3, 6, 8):
        out[f"exif{orientation}.jpg"] = splice_after_app0(
            base, exif_app1(orientation, little_endian=orientation != 8))
    # the VOC-sized frames: width x height 500x375, 375x500, 500x333
    out["voc_500x375_q90.jpg"] = encode(photograph(20, 375, 500), 90)
    out["voc_375x500_q75.jpg"] = encode(photograph(21, 500, 375), 75)
    out["voc_500x333_q95.jpg"] = encode(photograph(22, 333, 500), 95)
    out["voc_500x375_progressive.jpg"] = encode(photograph(23, 375, 500),
                                                85, progressive=True)
    return out


def digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def manifest_entry(data):
    buf = np.frombuffer(data, np.uint8)
    color = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    gray = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    return {"shape": list(color.shape), "sha256_color": digest(color),
            "sha256_gray": digest(gray)}


def main():
    manifest = {"decoder": f"cv2 {cv2.__version__}", "files": {}}
    for name, data in sorted(fixtures().items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest["files"][name] = manifest_entry(data)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
