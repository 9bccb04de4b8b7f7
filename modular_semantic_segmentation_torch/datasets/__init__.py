"""Dataset registry (the port's copy of the JAX package's
``datasets/__init__.py``), with lazy class exports.

Only the synthetic in-repo dataset ``unittest`` is ported; every other name
of the JAX package's registry raises ``NotImplementedError`` (ROADMAP.md,
section 1, item A3), and an unknown name the JAX package's
``UserWarning``.
"""

import importlib

_REGISTRY = {
    "unittest": ("unittest_data", "UnittestData"),
}

#: the JAX package's other datasets, by registry name and class name
_NOT_PORTED = {
    "synthia": "Synthia",
    "synthia_cityscapes": "SynthiaCityscapes",
    "cityscapes": "Cityscapes",
    "cityscapes_c": "Cityscapes",
    "cityscapes_a": "CityscapesA",
    "cityscapes_b": "CityscapesB",
    "synthia_rand": "SynthiaRand",
    "raw_synthia": "RawSynthia",
    "pascalvoc": "PascalVOC",
    "toydata": "ToyData",
    "mixeddata": "MixedData",
    "add_random_objects": "AddRandomObjects",
}


def get_dataset(name):
    """Look up a dataset class by registry name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"dataset '{name}' is not ported yet (ROADMAP.md, section 1, "
            "item A3)")
    try:
        module_name, cls_name = _REGISTRY[name]
    except KeyError:
        raise UserWarning(f"ERROR: Dataset {name} not found") from None
    module = importlib.import_module(
        f"modular_semantic_segmentation_torch.datasets.{module_name}")
    return getattr(module, cls_name)


_CLASS_NAMES = {
    **{cls: name for name, cls in _NOT_PORTED.items()},
    **{cls: name for name, (_, cls) in _REGISTRY.items()}}


def __getattr__(name):
    """Lazy class exports (PEP 562): ``from ...datasets import
    UnittestData`` without importing every dataset module up front."""
    if name in _CLASS_NAMES:
        return get_dataset(_CLASS_NAMES[name])
    raise AttributeError(name)
