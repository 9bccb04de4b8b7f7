"""Cityscapes variant A (the port's copy of the JAX package's
``datasets/cityscapes_a.py``): the measureset is drawn from the held-out
train cities ulm and bochum instead of a random train split."""

from modular_semantic_segmentation_torch.datasets.cityscapes import (
    CITIES, LABELINFO, Cityscapes)
from modular_semantic_segmentation_torch.datasets.data_baseclass import \
    DataBaseclass

MEASURE_CITIES = ["ulm", "bochum"]


class CityscapesA(Cityscapes):

    def __init__(self, base_path=None, num_classes=None, **data_config):
        train_cities = [c for c in CITIES if c not in MEASURE_CITIES]
        Cityscapes.__init__(self, base_path=base_path, cities=train_cities,
                            num_classes=num_classes, **data_config)
        # replace the random measure split with the held-out cities
        trainset = self.trainset + self.measureset
        measureset = self._get_filenames("train", cities=MEASURE_CITIES)
        testset = self.testset
        DataBaseclass.__init__(self, trainset, measureset, testset,
                               LABELINFO, num_classes=num_classes)
