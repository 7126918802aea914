from setuptools import find_packages, setup

setup(
    name="unirec-tpu",
    version="0.1.0",
    description="TPU-native universal recommendation framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    package_data={"unirec_tpu": ["config/*.yaml", "config/model/*.yaml",
                                 "config/dataset/*.yaml",
                                 "native/*.cc"],
                  "unirec_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cc",
                                       "serving/cpp/*.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pandas", "pyyaml"],
    entry_points={"console_scripts": ["unirec-tpu = unirec_tpu.cli:main"]},
)
