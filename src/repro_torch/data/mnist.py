"""Synthetic MNIST-like task for the paper's NN-accelerator case study.

Real MNIST is unavailable offline; this generator produces a 10-class 28x28
image task whose MLP test error lands near the paper's fault-free 2.56%
(paper Fig. 3). Class prototypes are smooth low-frequency images (7x7 noise
bilinearly upsampled); samples add pixel noise + small random shifts so the
task is non-trivially separable.
"""

from __future__ import annotations

import numpy as np

IMG = 28
N_CLASSES = 10


def _upsample(x: np.ndarray, factor: int) -> np.ndarray:
    """Bilinear upsample of a (h, w) grid by `factor`."""
    h, w = x.shape
    out_h, out_w = h * factor, w * factor
    yi = np.linspace(0, h - 1, out_h)
    xi = np.linspace(0, w - 1, out_w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    return (
        x[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + x[np.ix_(y1, x0)] * wy * (1 - wx)
        + x[np.ix_(y0, x1)] * (1 - wy) * wx
        + x[np.ix_(y1, x1)] * wy * wx
    )


def prototypes(seed: int = 0) -> np.ndarray:
    rng = np.random.Generator(np.random.Philox(key=(seed ^ (0xB10B << 32), 0)))
    protos = []
    for _ in range(N_CLASSES):
        low = rng.standard_normal((7, 7))
        protos.append(_upsample(low, 4))
    p = np.stack(protos)  # (10, 28, 28)
    return (p - p.mean()) / (p.std() + 1e-9)


def make_dataset(n: int, seed: int = 0, noise: float = 1.25, split: str = "train"):
    """Returns (images (n, 784) float32, labels (n,) int32)."""
    salt = {"train": 1, "test": 2}[split]
    rng = np.random.Generator(np.random.Philox(key=(seed ^ (0xDA7A << 32), salt)))
    protos = prototypes(seed)
    labels = rng.integers(0, N_CLASSES, size=n)
    imgs = protos[labels]
    # small random translations (+-2 px) make classes overlap a little
    shifts = rng.integers(-2, 3, size=(n, 2))
    imgs = np.stack(
        [np.roll(np.roll(im, s[0], axis=0), s[1], axis=1) for im, s in zip(imgs, shifts)]
    )
    imgs = imgs + noise * rng.standard_normal(imgs.shape)
    return imgs.reshape(n, -1).astype(np.float32), labels.astype(np.int32)
