"""SYNTHIA sequences at their raw resolution with online augmentation (the
port's copy of the JAX package's ``datasets/raw_synthia.py``).

It reads the split JSON that :class:`Synthia`'s preprocessing persists,
and the raw frames; the training format applies the configured scale,
crop, flips and gamma; every blob is cropped to multiples of 16.
"""

import json
from os import path

import numpy as np

from modular_semantic_segmentation_torch.datasets import image_io
from modular_semantic_segmentation_torch.datasets.augmentation import (
    augmentate, crop_multiple)
from modular_semantic_segmentation_torch.datasets.data_baseclass import (
    DataBaseclass, train_test_split)
from modular_semantic_segmentation_torch.datasets.synthia import (
    AVAILABLE_SEQUENCES, LABELINFO, one_channel_image_reader,
    synthia_basepath)


class RawSynthia(DataBaseclass):

    _data_shape_description = {
        "rgb": (None, None, 3), "depth": (None, None, 1),
        "labels": (None, None)}
    _num_default_classes = 14

    def __init__(self, seqs=None, base_path=None, direction="F",
                 num_classes=None, **data_config):
        seqs = seqs or AVAILABLE_SEQUENCES
        base_path = base_path or synthia_basepath()
        config = {
            "preprocessing": {
                "scale": [.4, 0.7, 1.5],
                "crop": [1, 352],
                "hflip": False,
                "vflip": .3,
                "gamma": [.4, 0.3, 1.2],
                "force_multiple": 16,
            },
        }
        config.update(data_config)
        self.config = config
        self.base_path = base_path
        self.direction = direction

        trainset, testset = [], []
        for sequence in seqs:
            split_file = path.join(base_path, sequence,
                                   "train_test_split.json")
            with open(split_file) as f:
                split = json.load(f)
            trainset.extend([{"sequence": sequence, "image_name": n}
                             for n in split["trainset"]])
            testset.extend([{"sequence": sequence, "image_name": n}
                            for n in split["testset"]])
        measureset, testset = train_test_split(testset, test_size=0.5,
                                               random_state=1)
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)

    def _get_data(self, sequence, image_name, training_format=False):
        d = self.direction
        seq_base = path.join(self.base_path, sequence)
        blob = {}
        blob["rgb"] = image_io.imread(path.join(
            seq_base, "RGB/Stereo_Right", f"Omni_{d}", f"{image_name}.png"))
        blob["depth"] = one_channel_image_reader(path.join(
            seq_base, "Depth/Stereo_Right", f"Omni_{d}",
            f"{image_name}.png"), np.uint16)
        labels = one_channel_image_reader(path.join(
            seq_base, "GT/LABELS/Stereo_Right", f"Omni_{d}",
            f"{image_name}.png"), np.uint8).astype(np.int32)
        labels[labels == 15] = 13
        blob["labels"] = labels

        if training_format:
            pre = self.config["preprocessing"]
            blob = augmentate(blob, scale=pre.get("scale", False),
                              crop=pre.get("crop", False),
                              hflip=pre.get("hflip", False),
                              vflip=pre.get("vflip", False),
                              gamma=pre.get("gamma", False))
        for m in list(blob):
            blob[m] = crop_multiple(
                blob[m], self.config["preprocessing"].get("force_multiple",
                                                          16))
        if blob["depth"].ndim == 2:
            blob["depth"] = np.expand_dims(blob["depth"], -1)
        blob["rgb"] = blob["rgb"].astype(np.float32)
        blob["depth"] = blob["depth"].astype(np.float32)
        blob["labels"] = blob["labels"].astype(np.int32)
        return blob
