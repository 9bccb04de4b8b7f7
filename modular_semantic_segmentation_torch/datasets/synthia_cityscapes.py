"""SYNTHIA-RAND_CITYSCAPES stills driver (the port's copy of the JAX
package's ``datasets/synthia_cityscapes.py``).

12 classes, 13 with the optional lanemarking class; the hard label remap
of the AdapNet paper; a 50/50 measure/test split of the testset (seed 1);
an optional resize to 768x384 (bilinear rgb with the native library,
nearest depth and labels); an optional in-memory mode that unpacks the
tar archive into ``TMPDIR``.
"""

import json
import tarfile
from copy import deepcopy
from os import environ, path

import numpy as np

from modular_semantic_segmentation_torch.datasets import (
    image_io, native_backend)
from modular_semantic_segmentation_torch.datasets.augmentation import \
    augmentate
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)
from modular_semantic_segmentation_torch.datasets.synthia import \
    synthia_basepath

LABELINFO = {
    0: {"name": "void", "color": [0, 0, 0]},
    1: {"name": "sky", "color": [128, 128, 128]},
    2: {"name": "building", "color": [128, 0, 0]},
    3: {"name": "road", "color": [128, 64, 128]},
    4: {"name": "sidewalk", "color": [0, 0, 192]},
    5: {"name": "fence", "color": [64, 64, 128]},
    6: {"name": "vegetation", "color": [128, 128, 0]},
    7: {"name": "pole", "color": [192, 192, 128]},
    8: {"name": "car", "color": [64, 0, 128]},
    9: {"name": "traffic sign", "color": [192, 128, 128]},
    10: {"name": "pedestrian", "color": [64, 64, 0]},
    11: {"name": "bicycle", "color": [0, 128, 192]},
}

# (original label, target) of the AdapNet paper's remap, applied in order
_REMAP = ((12, 11),   # motorcycle -> bicycle
          (13, 12),   # parking spot -> lanemarking
          (14, 0),    # road_work -> void
          (15, 0),    # traffic light -> void
          (16, 0),    # terrain -> void
          (17, 11),   # rider -> bicycle
          (18, 8),    # truck -> car
          (19, 8),    # bus -> car
          (20, 0),    # train -> void
          (21, 0),    # wall -> void
          (22, 12))   # lanemarking


def resize_blob(blob, dsize=(768, 384)):
    """The rgb resized bilinear, depth and labels nearest, to ``dsize``
    (width, height), as the drivers' ``resize`` option does it."""
    blob["rgb"] = native_backend.resize(
        blob["rgb"], interpolation=native_backend.INTER_LINEAR, dsize=dsize)
    for m in ("depth", "labels"):
        blob[m] = native_backend.resize(
            blob[m], interpolation=native_backend.INTER_NEAREST, dsize=dsize)
    return blob


class SynthiaCityscapes(DataBaseclass):
    """Driver for SYNTHIA-RAND_CITYSCAPES."""

    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}
    _num_default_classes = 12

    def __init__(self, base_path=None, force_preprocessing=False,
                 resize=False, in_memory=False, num_classes=None,
                 **data_config):
        base_path = base_path or synthia_basepath()
        config = {
            "augmentation": {
                "crop": [1, 240],
                "scale": [.4, 0.7, 1.5],
                "vflip": .3,
                "hflip": False,
                "gamma": [.4, 0.3, 1.2],
                "rotate": [.4, -13, 13],
                "shear": [0, 0.01, 0.03],
                "contrast": [.3, 0.5, 1.5],
                "brightness": [.2, -40, 40],
            },
            "labels": {"lanemarkings": False},
        }
        config.update(data_config)
        config.update({"resize": resize})
        self.config = config

        if not path.exists(base_path):
            message = "ERROR: Path to SYNTHIA dataset does not exist."
            print(message)
            raise IOError(1, message, base_path)
        self.basepath = path.join(base_path, "RAND_CITYSCAPES")

        if in_memory and "TMPDIR" in environ:
            print("INFO loading dataset into memory")
            with tarfile.open(path.join(base_path,
                                        "RAND_CITYSCAPES.tar.gz")) as tar:
                tar.extractall(path=environ["TMPDIR"], filter="data")
            self.basepath = environ["TMPDIR"]
            with open(path.join(self.basepath,
                                "train_test_split.json")) as f:
                split = json.load(f)
            trainset = [{"image": self._load_data(n)}
                        for n in split["trainset"]]
            testset = [{"image": self._load_data(n)}
                       for n in split["testset"]]
        else:
            if in_memory:
                print("INFO Environment Variable TMPDIR not set, could not "
                      "unpack data and load into memory\n"
                      "Now trying to load every image seperately")
            with open(path.join(self.basepath,
                                "train_test_split.json")) as f:
                split = json.load(f)
            trainset = [{"image_name": n} for n in split["trainset"]]
            testset = [{"image_name": n} for n in split["testset"]]

        measureset, testset = train_test_split(testset, test_size=0.5,
                                               random_state=1)

        labelinfo = deepcopy(LABELINFO)
        if self.config["labels"]["lanemarkings"]:
            labelinfo[12] = {"name": "lanemarking", "color": [0, 192, 0]}
        if num_classes is None:
            num_classes = len(labelinfo)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               labelinfo, num_classes=num_classes)

    def _load_data(self, image_name):
        rgb_file = path.join(self.basepath, "RGB/Stereo_Right/Omni_F",
                             f"{image_name}.png")
        depth_file = path.join(self.basepath, "Depth/Stereo_Right/Omni_F",
                               f"{image_name}.png")
        labels_file = path.join(self.basepath,
                                "GT/LABELS_NPY/Stereo_Right/Omni_F",
                                f"{image_name}.npy")
        blob = {}
        blob["rgb"] = image_io.imread(rgb_file)
        blob["depth"] = image_io.imread(depth_file, image_io.IMREAD_ANYDEPTH)
        labels = np.load(labels_file).astype(np.int32)
        for original, target in _REMAP:
            labels[labels == original] = target
        if not self.config["labels"]["lanemarkings"]:
            labels[labels == 12] = 0
        blob["labels"] = labels

        if self.config["resize"]:
            blob = resize_blob(blob)
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
            aug = self.config["augmentation"]
            blob = augmentate(blob, scale=aug["scale"], crop=aug["crop"],
                              hflip=aug["hflip"], vflip=aug["vflip"],
                              gamma=aug["gamma"], contrast=aug["contrast"],
                              brightness=aug["brightness"],
                              rotate=aug["rotate"], shear=aug["shear"])
        if blob["depth"].ndim == 2:
            blob["depth"] = np.expand_dims(blob["depth"], -1)
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["depth"] = blob["depth"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
