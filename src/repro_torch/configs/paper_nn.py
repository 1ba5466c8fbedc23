"""The paper's own workload: the FPGA NN-accelerator case study (§IV).

An MLP classifier (MNIST-class tasks, per [16]'s methodology) whose weights
live in the ECC-protected BRAM voltage domain as int8 fixed-point — the
configuration undervolted in paper Fig. 3.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperNNConfig:
    name: str = "paper-nn"
    family: str = "mlp"
    layer_sizes: tuple = (784, 256, 128, 10)  # 28x28 MNIST -> 10 classes
    dataset: str = "mnist"
    platform: str = "vc707"
    train_steps: int = 600
    batch_size: int = 128
    lr: float = 3e-3


def config() -> PaperNNConfig:
    return PaperNNConfig()


def smoke_config() -> PaperNNConfig:
    return dataclasses.replace(config(), layer_sizes=(64, 32, 10), train_steps=40)
