"""modular_semantic_segmentation_torch — the PyTorch/CUDA port of
``modular_semantic_segmentation_tpu`` for NVIDIA Hopper (H100).

Per-modality expert CNNs (SimpleFCN/VGG16) whose per-pixel outputs are fused
by statistical fusion layers (Bayes over confusion-matrix likelihoods,
class-conditional Dirichlet densities, averaging, MC-dropout variance
weighting, uncertainty-modulated Dirichlet), and BayesianFCN's MC-dropout
uncertainty, and the training of the expert networks. Module names follow
the JAX package so each file has an obvious counterpart there; the JAX
package stays the reference this port is tested against.

Layout:
    ops/        layers, fusion math, metrics, losses, optimizers;
                ops/cuda/ wraps the hand-written Hopper kernels in csrc/
    models/     Estimator runtime (train step, fit, eval, checkpoints),
                SimpleFCN, the fusion family
                (Bayes, Dirichlet, Average, Variance, Uncertainty-Dirichlet),
                UncertaintyModel and BayesianFCN; int8 post-training
                quantization (quantize, packed_experts)
    utils/      host-side batch plumbing, event-file writer, profiling
    serving.py  frame-at-a-time inference server and the deployment
                artifact (export_serving / ExportedServing)
    parallel/   meshes over torch.distributed ranks: data, tensor and
                spatial parallelism, pipeline and expert dispatch

Public tensors are NHWC, as in the JAX package. Entry points take a
``device`` argument that defaults to ``"cuda"``; pass ``"cpu"`` to run the
plain PyTorch versions of the kernels (as the tests do).

The port imports ``torch``, ``numpy``, ``scipy`` and the standard library,
and nothing of JAX or of the JAX package.
"""

__version__ = "0.1.0"

_EXPORTS = {"get_model": "models", "calibrate_amax": "models.quantize",
            "select_scales": "models.quantize"}


def __getattr__(name):
    """Lazy exports (PEP 562), so that importing a module of the package
    (``serving`` for an exported program) loads no model module."""
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(name)
