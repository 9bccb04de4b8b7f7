from setuptools import setup, find_packages

setup(
    name="modular_semantic_segmentation_tpu",
    version="0.1.0",
    description=("TPU-native modular sensor fusion for semantic "
                 "segmentation (JAX/XLA/Pallas)"),
    packages=find_packages(
        include=["modular_semantic_segmentation_tpu",
                 "modular_semantic_segmentation_tpu.*", "experiments",
                 "modular_semantic_segmentation_torch",
                 "modular_semantic_segmentation_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "optax", "numpy", "scipy", "scikit-learn", "opencv-python",
        "pyyaml", "pandas", "tqdm",
    ],
    # the PyTorch/CUDA port needs torch, numpy and scipy only
    extras_require={"torch": ["torch", "numpy", "scipy"]},
    package_data={
        "modular_semantic_segmentation_tpu": ["native/Makefile",
                                              "native/*.cc"],
        "modular_semantic_segmentation_torch": [
            "csrc/*.cu", "experiments/example_config.json"],
    },
)
