"""Cityscapes variant B (the port's copy of the JAX package's
``datasets/cityscapes_b.py``): optionally the gtCoarse 'train_extra'
images in the trainset; the measureset is val munster, the testset val
frankfurt and lindau."""

from os import path

from modular_semantic_segmentation_torch.datasets.cityscapes import (
    LABELINFO, Cityscapes)
from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    DataBaseclass


class CityscapesB(Cityscapes):

    def __init__(self, base_path=None, use_train_extra=False,
                 num_classes=None, **data_config):
        Cityscapes.__init__(self, base_path=base_path,
                            num_classes=num_classes, **data_config)
        trainset = self.trainset + self.measureset
        if use_train_extra and path.exists(
                path.join(self.base_path, self.modality_paths["rgb"],
                          "train_extra")):
            self.modality_paths = dict(self.modality_paths)
            trainset = trainset + self._get_filenames("train_extra")
        measureset = self._get_filenames("val", cities=["munster"])
        testset = self._get_filenames("val",
                                      cities=["frankfurt", "lindau"])
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)
