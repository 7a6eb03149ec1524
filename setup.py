"""Install: pip install -e .  (builds the native host-kit on first use).

`pip install -e .[torch]` adds PyTorch for the GPU port
(mm2_gb_tpu_torch, console script mm2-gb-tpu-torch); its CUDA kernels
are compiled with nvcc on first use.
"""

from setuptools import find_packages, setup

setup(
    name="mm2-gb-tpu",
    version="0.1.0",
    description="TPU-native long-read mapper with mm2-gb capabilities",
    packages=find_packages(include=["mm2_gb_tpu", "mm2_gb_tpu.*",
                                    "mm2_gb_tpu_torch",
                                    "mm2_gb_tpu_torch.*"]),
    package_data={"mm2_gb_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                       "csrc/host/*.cpp", "csrc/host/*.h",
                                       "configs/*.json"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"torch": ["torch"]},
    entry_points={"console_scripts": [
        "mm2-gb-tpu=mm2_gb_tpu.cli:main",
        "mm2-gb-tpu-torch=mm2_gb_tpu_torch.cli:main",
    ]},
)
