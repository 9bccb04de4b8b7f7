"""SYNTHIA-RAND driver with online preprocessing and the 23 -> 13 class
mapping (the port's copy of the JAX package's
``datasets/synthia_rand.py``)."""

import json
from os import path

import numpy as np

from modular_semantic_segmentation_torch import settings
from modular_semantic_segmentation_torch.datasets import image_io
from modular_semantic_segmentation_torch.datasets.augmentation import (
    augmentate, crop_multiple)
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)

# original SYNTHIA id -> target class name
ORIGINAL_LABELINFO = {
    0: "void", 1: "sky", 2: "building", 3: "road", 4: "sidewalk",
    5: "fence", 6: "vegetation", 7: "pole", 8: "vehicle",
    9: "traffic sign", 10: "person", 11: "bicycle", 12: "vehicle",
    13: "road", 14: "void", 15: "traffic light", 16: "vegetation",
    17: "person", 18: "vehicle", 19: "vehicle", 20: "vehicle",
    21: "building", 22: "road",
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
    12: {"name": "traffic light", "color": [0, 128, 128]},
}


class SynthiaRand(DataBaseclass):

    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}
    _num_default_classes = 13

    def __init__(self, base_path=None, num_classes=None, **data_config):
        base_path = base_path or path.join(settings.DATA_BASEPATH,
                                           "synthia_rand")
        config = {
            "direction": "F",
            "preprocessing": {
                "type": "online",
                "scale": [.4, 0.7, 1.5],
                "crop": [1, 240],
                "hflip": False,
                "vflip": .3,
                "gamma": [.4, 0.3, 1.2],
                "force_multiple": 16,
            },
        }
        config.update(data_config)
        self.config = config

        if not path.exists(base_path):
            message = "ERROR: Path to SYNTHIA-RAND dataset does not exist."
            print(message)
            raise IOError(1, message, base_path)
        self.base_path = base_path

        with open(path.join(base_path, "train_test_split.json")) as f:
            split = json.load(f)
        trainset = [{"image_name": n} for n in split["trainset"]]
        testset = [{"image_name": n} for n in split["testset"]]
        measureset, testset = train_test_split(testset, test_size=0.5,
                                               random_state=1)

        self.label_lookup = np.array(
            [next(i for i in LABELINFO
                  if LABELINFO[i]["name"] == ORIGINAL_LABELINFO[k])
             for k in sorted(ORIGINAL_LABELINFO)], np.int32)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)

    def _get_data(self, image_name, training_format=False):
        pre = self.config["preprocessing"]
        blob = {}
        blob["rgb"] = image_io.imread(path.join(
            self.base_path, "RGB/Stereo_Right/Omni_F", f"{image_name}.png"))
        blob["depth"] = image_io.imread(path.join(
            self.base_path, "Depth/Stereo_Right/Omni_F",
            f"{image_name}.png"), image_io.IMREAD_ANYDEPTH)
        labels = np.load(path.join(
            self.base_path, "GT/LABELS_NPY/Stereo_Right/Omni_F",
            f"{image_name}.npy")).astype(np.int32)
        blob["labels"] = self.label_lookup[labels]

        if training_format:
            blob = augmentate(blob, scale=pre.get("scale", False),
                              crop=pre.get("crop", False),
                              hflip=pre.get("hflip", False),
                              vflip=pre.get("vflip", False),
                              gamma=pre.get("gamma", False))
        multiple = pre.get("force_multiple", 16)
        for m in list(blob):
            blob[m] = crop_multiple(blob[m], multiple)
        if blob["depth"].ndim == 2:
            blob["depth"] = np.expand_dims(blob["depth"], -1)
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["depth"] = blob["depth"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
