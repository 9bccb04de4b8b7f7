"""Model registry: the JAX package's registry, under its names.

Lazy imports, as in the JAX package; an unknown or not yet ported name
raises the JAX package's ``UserWarning``. The int8 serving functions
(``calibrate_amax``, ``select_scales``, ``can_pack_stems``,
``packed_fcn_stems``) are exported lazily too.
"""

import importlib

_REGISTRY = {
    "fcn": ("simple_fcn", "SimpleFCN"),
    "simple_fcn": ("simple_fcn", "SimpleFCN"),
    "fusion_fcn": ("fusion_fcn", "FusionFCN"),
    "bayes_mix": ("bayes_fusion", "BayesFusion"),
    "bayes_fusion": ("bayes_fusion", "BayesFusion"),
    "dirichlet_mix": ("dirichlet_fusion", "DirichletFusion"),
    "dirichlet_fusion": ("dirichlet_fusion", "DirichletFusion"),
    "average": ("average_fusion", "AverageFusion"),
    "average_fusion": ("average_fusion", "AverageFusion"),
    "variance": ("variance_fusion", "VarianceFusion"),
    "variance_fusion": ("variance_fusion", "VarianceFusion"),
    "adapnet": ("adapnet", "Adapnet"),
    "bayesian_fcn": ("bayesian_fcn", "BayesianFCN"),
    "progressive_fcn": ("progressive_fcn", "ProgressiveFCN"),
    "uncertainty_dirichlet_mix": ("uncertainty_dirichlet_fusion",
                                  "UncertaintyDirichletFusion"),
}


def get_model(name):
    """Look up a model class by registry name."""
    try:
        module_name, cls_name = _REGISTRY[name]
    except KeyError:
        raise UserWarning(f"ERROR: Model {name} not found") from None
    module = importlib.import_module(
        f"modular_semantic_segmentation_torch.models.{module_name}")
    return getattr(module, cls_name)


_FUNCTIONS = {"calibrate_amax": "quantize", "select_scales": "quantize",
              "can_pack_stems": "packed_experts",
              "packed_fcn_stems": "packed_experts"}


def __getattr__(name):
    """Lazy exports (PEP 562) of the int8 serving functions."""
    if name in _FUNCTIONS:
        module = importlib.import_module(
            f"modular_semantic_segmentation_torch.models.{_FUNCTIONS[name]}")
        return getattr(module, name)
    raise AttributeError(name)
