from setuptools import find_packages, setup

setup(
    name="adaptive-classifier-tpu",
    version="0.1.0",
    description="TPU-native adaptive text classification (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests", "scripts", "examples", "native")),
    # the PyTorch/CUDA port ships its CUDA sources; nvcc builds them on first use
    package_data={"adaptive_classifier_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "flax",
        "safetensors",
    ],
    extras_require={
        "test": ["pytest"],
        "hub": ["huggingface_hub"],
    },
)
