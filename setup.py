from setuptools import find_packages, setup

setup(
    name="audiossl_tpu",
    version="0.1.0",
    description=("TPU-native audio self-supervised learning framework "
                 "(ATST-Clip / ATST-Frame, downstream suite, SED stack)"),
    packages=find_packages(include=["audiossl_tpu", "audiossl_tpu.*",
                                    "audiossl_tpu_torch",
                                    "audiossl_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy",
        "pandas", "einops",
    ],
    entry_points={
        "console_scripts": [
            # same CLI surface as the reference (setup.py:8-13)
            "atst_train=audiossl_tpu.methods.atst.train:main",
            "atstframe_train=audiossl_tpu.methods.atstframe.train:main",
            "atst_downstream_train_freeze="
            "audiossl_tpu.downstream.train_freeze:main",
            # config-file variant (reference train_freeze_hydra.py)
            "atst_downstream_train_freeze_config="
            "audiossl_tpu.downstream.train_freeze_config:main",
            "atst_downstream_train_finetune="
            "audiossl_tpu.downstream.train_finetune:main",
        ]
    },
)
