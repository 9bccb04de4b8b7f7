"""The Cityscapes driver (the port's copy of the JAX package's
``datasets/cityscapes.py``): rgb, disparity as 'depth', and the gtFine
labels with the 34 -> 12 class mapping.

Splits: the trainset from 18 cities, the testset from the val cities
munster, frankfurt and lindau, the measureset 5% of the trainset (seed
4). An optional resize to 768x384 (bilinear rgb with the native library,
nearest depth and labels).
"""

import tarfile
from copy import deepcopy
from os import environ, listdir, path

import numpy as np

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import image_io
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)
from modular_semantic_segmentation_torch.datasets.synthia_cityscapes import \
    resize_blob

CITIES = ["aachen", "bremen", "darmstadt", "erfurt", "hanover", "krefeld",
          "strasbourg", "tubingen", "weimar", "bochum", "cologne",
          "dusseldorf", "hamburg", "jena", "monchengladbach", "stuttgart",
          "ulm", "zurich"]

# original id -> target class name
ORIGINAL_LABELINFO = {
    0: "void", 1: "void", 2: "void", 3: "void", 4: "void", 5: "void",
    6: "void", 7: "road", 8: "sidewalk", 9: "road", 10: "void",
    11: "building", 12: "building", 13: "fence", 14: "void", 15: "void",
    16: "void", 17: "pole", 18: "void", 19: "void", 20: "traffic sign",
    21: "vegetation", 22: "vegetation", 23: "sky", 24: "person",
    25: "person", 26: "vehicle", 27: "vehicle", 28: "vehicle",
    29: "vehicle", 30: "vehicle", 31: "vehicle", 32: "vehicle",
    33: "bicycle",
}

LABELINFO = {
    0: {"name": "void", "color": [0, 0, 0]},
    1: {"name": "sky", "color": [128, 128, 128]},
    2: {"name": "building", "color": [128, 0, 0]},
    3: {"name": "road", "color": [128, 64, 128]},
    4: {"name": "sidewalk", "color": [0, 0, 192]},
    5: {"name": "fence", "color": [64, 64, 128]},
    6: {"name": "vegetation", "color": [128, 128, 0]},
    7: {"name": "pole", "color": [192, 192, 128]},
    8: {"name": "vehicle", "color": [64, 0, 128]},
    9: {"name": "traffic sign", "color": [192, 128, 128]},
    10: {"name": "person", "color": [64, 64, 0]},
    11: {"name": "bicycle", "color": [0, 128, 192]},
}


def cityscapes_basepath():
    """``<DATA_BASEPATH>/cityscapes``, read from the settings when
    called."""
    return path.join(settings.DATA_BASEPATH, "cityscapes")


class Cityscapes(DataBaseclass):

    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}
    _num_default_classes = 12

    def __init__(self, base_path=None, in_memory=False, cities=None,
                 num_classes=None, **data_config):
        base_path = base_path or cityscapes_basepath()
        cities = cities if cities is not None else CITIES
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
            "resize": False,
        }
        config.update(data_config)
        self.config = config

        if not path.exists(base_path):
            message = "ERROR: Path to CITYSCAPES dataset does not exist."
            print(message)
            raise IOError(1, message, base_path)
        self.base_path = base_path
        self.modality_paths = {
            "rgb": "leftImg8bit_trainvaltest/leftImg8bit",
            "labels": "gtFine_trainvaltest/gtFine",
            "depth": "disparity_trainvaltest/disparity",
        }
        self.modality_suffixes = {
            "rgb": "leftImg8bit", "labels": "gtFine_labelIds",
            "depth": "disparity",
        }
        self.in_memory = in_memory
        self.label_lookup = [
            next(i for i in LABELINFO
                 if LABELINFO[i]["name"] == ORIGINAL_LABELINFO[k])
            for k in sorted(ORIGINAL_LABELINFO)]

        if self.in_memory and "TMPDIR" in environ:
            print("INFO loading dataset into machine ... ", end="")
            with tarfile.open(path.join(base_path,
                                        "cityscapes.tar.gz")) as tar:
                tar.extractall(path=environ["TMPDIR"], filter="data")
            self.base_path = environ["TMPDIR"]
            self.images = {}
            print("DONE")
        elif self.in_memory:
            print("INFO Environment Variable TMPDIR not set, could not "
                  "unpack data and load into memory\n"
                  "Now trying to load every image seperately")
            self.images = {}

        trainset = self._get_filenames("train", cities=cities)
        testset = self._get_filenames(
            "val", cities=["munster", "frankfurt", "lindau"])
        trainset, measureset = train_test_split(trainset, test_size=0.05,
                                                random_state=4)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)

    def _get_filenames(self, fileset, cities=False):
        filenames = []
        base_dir = path.join(self.base_path, self.modality_paths["rgb"],
                             fileset)
        for city in listdir(base_dir):
            if cities and city not in cities:
                continue
            search_path = path.join(base_dir, city)
            filenames.extend(
                [{"image_path": path.join(
                    fileset, city,
                    "_".join(path.splitext(n)[0].split("_")[:3]))}
                 for n in listdir(search_path)])
        return filenames

    def _load_data(self, image_path):
        rgb_file, depth_file, labels_file = (
            path.join(self.base_path, self.modality_paths[m],
                      f"{image_path}_{self.modality_suffixes[m]}.png")
            for m in ["rgb", "depth", "labels"])
        blob = {}
        blob["rgb"] = image_io.imread(rgb_file)
        blob["depth"] = image_io.imread(depth_file, image_io.IMREAD_ANYDEPTH)
        labels = image_io.imread(labels_file, image_io.IMREAD_ANYDEPTH)
        blob["labels"] = np.asarray(self.label_lookup,
                                    dtype="int32")[labels]
        if self.config["resize"]:
            blob = resize_blob(blob)
        blob["depth"] = np.expand_dims(blob["depth"], -1)
        return blob

    def _get_data(self, image_path, training_format=False):
        if self.in_memory:
            if image_path not in self.images:
                self.images[image_path] = self._load_data(image_path)
            cached = self.images[image_path]
            blob = {m: cached[m].copy() for m in cached}
        else:
            blob = self._load_data(image_path)
        if training_format:
            blob = augmentate(blob, **self.config["augmentation"])
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["depth"] = blob["depth"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob

    def get_ego_vehicle_mask(self, image_path):
        """The blob of an image whose labels are the binary mask of the ego
        vehicle (original class 1)."""
        old_lookup = deepcopy(self.label_lookup)
        self.label_lookup = [0] * 34
        self.label_lookup[1] = 1
        try:
            blob = self._load_data(image_path)
        finally:
            self.label_lookup = old_lookup
        return blob
