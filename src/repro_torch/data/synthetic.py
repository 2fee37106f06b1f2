"""Synthetic datasets.

`classification_csv` renders a synthetic tabular classification problem AS A
CSV STRING so the paper's whole upload->parse->preprocess path is exercised
end-to-end (including injected missing cells). The generating process is a
mixture of class-conditional Gaussians pushed through a random MLP, so there
is real structure for the swept DNNs to learn — needed to reproduce finding
F1 (accuracy flatlines past a capacity threshold).
"""
from __future__ import annotations

import numpy as np


def classification_arrays(n: int, n_features: int, n_classes: int, *,
                          seed: int = 0, noise: float = 0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    w = rng.normal(size=(n_features, n_features)) / np.sqrt(n_features)
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, n_features))
    x = np.tanh(x @ w) + noise * rng.normal(size=(n, n_features))
    return x.astype(np.float32), y


def classification_csv(n: int, n_features: int, n_classes: int, *,
                       seed: int = 0, missing_frac: float = 0.02) -> str:
    x, y = classification_arrays(n, n_features, n_classes, seed=seed)
    rng = np.random.default_rng(seed + 1)
    miss = rng.random((n, n_features)) < missing_frac
    header = ",".join([f"f{i}" for i in range(n_features)] + ["label"])
    lines = [header]
    for i in range(n):
        cells = ["" if miss[i, j] else f"{x[i, j]:.6f}"
                 for j in range(n_features)]
        cells.append(f"class_{y[i]}")
        lines.append(",".join(cells))
    return "\n".join(lines)
