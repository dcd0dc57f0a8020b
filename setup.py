"""Package setup (reference: /root/reference/setup.py pip package
'trackformer'). Also builds the native host library:
    python setup.py build_native
"""
import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup


class BuildNative(Command):
    description = "build the C++ host library (native/)"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        subprocess.check_call(["make", "-C",
                               str(Path(__file__).parent / "native")])


setup(
    name="trackformer_tpu",
    version="0.1.0",
    description=("TPU-native multi-object tracking with track-query "
                 "transformers (JAX/XLA/Pallas)"),
    packages=find_packages(include=["trackformer_tpu",
                                    "trackformer_tpu.*",
                                    "trackformer_tpu_torch",
                                    "trackformer_tpu_torch.*"]),
    package_data={"trackformer_tpu": ["cfgs/*.yaml"],
                  "trackformer_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                            "cfgs/*.yaml"]},
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "pyyaml",
        "pillow", "scipy",
    ],
    cmdclass={"build_native": BuildNative},
    entry_points={
        "console_scripts": [
            "trackformer-train=trackformer_tpu.cli.train:main",
            "trackformer-track=trackformer_tpu.cli.track:main",
        ],
    },
)
