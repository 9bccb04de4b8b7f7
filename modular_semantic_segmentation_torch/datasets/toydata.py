"""Synthetic 2-D four-quadrant classification data with label-ambiguity
augmentation, the fake backend of the uncertainty experiments (the port's
copy of the JAX package's ``datasets/toydata.py``). Points are drawn from
numpy's global generator, as in the JAX package."""

import numpy as np

from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    DataBaseclass


class ToyData(DataBaseclass):

    _num_default_classes = 4
    _data_shape_description = {"toy": (2,), "labels": ()}

    def __init__(self, **config):
        default_config = {
            "augmentation": {"label_flip": False, "label_merge": False}}
        default_config.update(config)
        self.config = default_config

        labelinfo = {
            0: {"name": "A", "color": [255, 0, 0]},
            1: {"name": "B", "color": [0, 255, 0]},
            2: {"name": "C", "color": [0, 0, 255]},
            3: {"name": "D", "color": [128, 128, 0]},
            4: {"name": "amb", "color": [0, 0, 0]},
        }
        DataBaseclass.__init__(
            self,
            [{"set": "train"} for _ in range(2000)],
            [{"set": "measure"} for _ in range(100)],
            [{"set": "test"} for _ in range(1000)],
            labelinfo,
            validation_set=[{"set": "validation"} for _ in range(1000)])

    def _get_data(self, set, training_format=False):
        blob = {}
        point = 3 * (np.random.rand(2) - 0.5)
        blob["toy"] = point.astype(np.float32)
        blob["labels"] = np.int32(
            (0 if point[1] > 0 else 1) if point[0] > 0
            else (2 if point[1] > 0 else 3))

        if training_format:
            flip = self.config["augmentation"].get("label_flip", False)
            if flip:
                c1, c2, p = flip
                if p < np.random.rand():
                    if blob["labels"] == c1:
                        blob["labels"] = np.int32(c2)
                    elif blob["labels"] == c2:
                        blob["labels"] = np.int32(c1)
            merge = self.config["augmentation"].get("label_merge", False)
            if merge:
                c1, c2 = merge
                if blob["labels"] == c2:
                    blob["labels"] = np.int32(c1)
        return blob
