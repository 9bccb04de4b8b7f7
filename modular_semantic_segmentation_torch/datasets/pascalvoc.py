"""The PascalVOC 2012 segmentation driver (the port's copy of the JAX
package's ``datasets/pascalvoc.py``): 21 classes, rgb and labels only.

Frames are the JPEG files of ``JPEGImages/``, read by ``image_io.imread``
(the port's decoder, equal to ``cv2.imread``); labels are the colour-coded
PNGs of ``SegmentationClass/`` (VOC's palette PNGs, read as BGR), mapped
to class ids by their colour, where any colour outside ``LABELINFO`` (the
void border 224,224,192 among them) maps to -1, which the losses and
metrics ignore.

Splits: the trainset from ``ImageSets/Segmentation/train.txt``, the
testset from ``val.txt``, the measureset 5% of the trainset (seed 4).
With ``in_memory`` and ``TMPDIR`` set, ``pascalvoc.tar.gz`` is extracted
into ``$TMPDIR`` and every frame is decoded up front.
"""

import tarfile
from os import environ, path

import numpy as np

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import image_io
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)

LABELINFO = {
    0: {"name": "background", "color": [0, 0, 0]},
    1: {"name": "aeroplane", "color": [128, 0, 0]},
    2: {"name": "bicycle", "color": [0, 128, 0]},
    3: {"name": "bird", "color": [128, 128, 0]},
    4: {"name": "boat", "color": [0, 0, 128]},
    5: {"name": "bottle", "color": [128, 0, 128]},
    6: {"name": "bus", "color": [0, 128, 128]},
    7: {"name": "car", "color": [128, 128, 128]},
    8: {"name": "cat", "color": [64, 0, 0]},
    9: {"name": "chair", "color": [192, 0, 0]},
    10: {"name": "cow", "color": [64, 128, 0]},
    11: {"name": "diningtable", "color": [192, 128, 0]},
    12: {"name": "dog", "color": [64, 0, 128]},
    13: {"name": "horse", "color": [192, 0, 128]},
    14: {"name": "motorbike", "color": [64, 128, 128]},
    15: {"name": "person", "color": [192, 128, 128]},
    16: {"name": "pottedplant", "color": [0, 64, 0]},
    17: {"name": "sheep", "color": [128, 64, 0]},
    18: {"name": "sofa", "color": [0, 192, 0]},
    19: {"name": "train", "color": [128, 192, 0]},
    20: {"name": "tvmonitor", "color": [0, 64, 128]},
}


def pascalvoc_basepath():
    """``<DATA_BASEPATH>/pascalvoc``, read from the settings when
    called."""
    return path.join(settings.DATA_BASEPATH, "pascalvoc")


class PascalVOC(DataBaseclass):

    _data_shape_description = {"rgb": (None, None, 3),
                               "labels": (None, None)}
    _num_default_classes = 21

    def __init__(self, base_path=None, in_memory=False, num_classes=None,
                 **data_config):
        base_path = base_path or pascalvoc_basepath()
        config = {
            "augmentation": {
                "crop": [1, 240],
                "scale": [.4, 1, 1.5],
                "vflip": .3,
                "hflip": False,
                "gamma": [.4, 0.3, 1.2],
                "rotate": False,
                "shear": False,
                "contrast": [.3, 0.5, 1.5],
                "brightness": [.2, -40, 40],
            },
        }
        config.update(data_config)
        self.config = config

        if not path.exists(base_path):
            message = "ERROR: Path to PascalVOC dataset does not exist."
            print(message)
            raise IOError(1, message, base_path)
        self.base_path = base_path

        # color (BGR as read by imread) -> class, as sorted colour codes
        # and their classes for a vectorised lookup
        self._color_lut = {}
        for key, info in LABELINFO.items():
            r, g, b = info["color"]
            self._color_lut[(b, g, r)] = key
        codes = {(b * 256 + g) * 256 + r: cls
                 for (b, g, r), cls in self._color_lut.items()}
        self._codes = np.array(sorted(codes), np.int64)
        self._code_classes = np.array([codes[c] for c in self._codes],
                                      np.int32)

        def get_filenames(fileset):
            listfile = path.join(self.base_path, "ImageSets/Segmentation",
                                 f"{fileset}.txt")
            with open(listfile) as f:
                return [{"image_name": line.strip()}
                        for line in f if line.strip()]

        if in_memory and "TMPDIR" in environ:
            print("INFO loading dataset into memory")
            with tarfile.open(path.join(base_path,
                                        "pascalvoc.tar.gz")) as tar:
                tar.extractall(path=environ["TMPDIR"], filter="data")
            self.base_path = environ["TMPDIR"]
            trainset = [{"image": self._load_data(i["image_name"])}
                        for i in get_filenames("train")]
            testset = [{"image": self._load_data(i["image_name"])}
                       for i in get_filenames("val")]
        else:
            trainset = get_filenames("train")
            testset = get_filenames("val")

        trainset, measureset = train_test_split(trainset, test_size=0.05,
                                                random_state=4)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)

    def _map_colors(self, label_img):
        """BGR colour image -> class indices; unknown colours -> -1. The
        JAX package indexes a 2**24-entry table built on every call; this
        looks the 21 colour codes up by binary search, with equal
        results."""
        flat = label_img.reshape(-1, 3)
        ids = (flat[:, 0].astype(np.int64) * 256 + flat[:, 1]) * 256 + \
            flat[:, 2]
        index = np.minimum(np.searchsorted(self._codes, ids),
                           len(self._codes) - 1)
        labels = np.where(self._codes[index] == ids,
                          self._code_classes[index], np.int32(-1))
        return labels.reshape(label_img.shape[:2])

    def _load_data(self, image_name):
        blob = {}
        blob["rgb"] = image_io.imread(path.join(
            self.base_path, "JPEGImages", f"{image_name}.jpg"))
        labels = image_io.imread(path.join(
            self.base_path, "SegmentationClass", f"{image_name}.png"))
        blob["labels"] = self._map_colors(labels)
        return blob

    def _get_data(self, image_name=False, image=False,
                  training_format=False):
        if not image_name and image is False:
            raise AssertionError("need image_name or image")
        if image_name:
            blob = self._load_data(image_name)
        else:
            blob = {m: image[m].copy() for m in image}
        if training_format:
            blob = augmentate(blob, **self.config["augmentation"])
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
