"""Dataset registry (the port's copy of the JAX package's
``datasets/__init__.py``), with lazy class exports.

Every name of the JAX package's registry resolves to the port's driver
(``pascalvoc`` reads its JPEG frames with the port's own decoder); an
unknown name raises the JAX package's ``UserWarning``.
"""

import importlib

_REGISTRY = {
    "synthia": ("synthia", "Synthia"),
    "synthia_cityscapes": ("synthia_cityscapes", "SynthiaCityscapes"),
    "cityscapes": ("cityscapes", "Cityscapes"),
    "cityscapes_c": ("cityscapes", "Cityscapes"),
    "cityscapes_a": ("cityscapes_a", "CityscapesA"),
    "cityscapes_b": ("cityscapes_b", "CityscapesB"),
    "synthia_rand": ("synthia_rand", "SynthiaRand"),
    "raw_synthia": ("raw_synthia", "RawSynthia"),
    "toydata": ("toydata", "ToyData"),
    "mixeddata": ("mixed_data", "MixedData"),
    "add_random_objects": ("not_cityscapes", "AddRandomObjects"),
    "unittest": ("unittest_data", "UnittestData"),
    "pascalvoc": ("pascalvoc", "PascalVOC"),
}


def get_dataset(name):
    """Look up a dataset class by registry name."""
    try:
        module_name, cls_name = _REGISTRY[name]
    except KeyError:
        raise UserWarning(f"ERROR: Dataset {name} not found") from None
    module = importlib.import_module(
        f"modular_semantic_segmentation_torch.datasets.{module_name}")
    return getattr(module, cls_name)


_CLASS_NAMES = {cls: name for name, (_, cls) in _REGISTRY.items()}


def __getattr__(name):
    """Lazy class exports (PEP 562): ``from ...datasets import Synthia``
    without importing every dataset module up front."""
    if name in _CLASS_NAMES:
        return get_dataset(_CLASS_NAMES[name])
    raise AttributeError(name)
