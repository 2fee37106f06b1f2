"""The paper's data-upload + preprocessing stage, as a library (a copy of
the reference's `repro.data.pipeline`; numpy only).

Faithful to §"Tasks Management":
  1. CSV ingest (the Papa Parse stage) — tolerant of missing cells, which are
     NOT errors ("missing data was not considered an error, due to the
     desired compatibility with sparse datasets"); missing -> 0.0.
  2. Feature scaling to [0, 1]  (paper best-practice 1, citing Hinton).
  3. One-hot encoding of the categorical label (best-practice 2).
  4. 80/20 train/test split (best-practice 3).

All steps are pure numpy and property-tested (tests/test_data_pipeline.py).
"""
from __future__ import annotations

import io
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


class CSVFormatError(ValueError):
    """Structural CSV error -> surfaced to the user, process aborted
    (paper: Papa Parse 'would throw an error ... and the process aborted')."""


@dataclass
class Dataset:
    x_train: np.ndarray
    y_train: np.ndarray        # one-hot (N, n_classes)
    x_test: np.ndarray
    y_test: np.ndarray
    classes: List[str]
    feature_names: List[str]

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]

    @property
    def n_classes(self) -> int:
        return len(self.classes)


def parse_csv(text: str, *, delimiter: str = ",") -> tuple:
    """Parse CSV text -> (header, rows of str cells). Raises CSVFormatError on
    ragged rows (structural), NOT on missing values (empty cells are fine)."""
    lines = [ln for ln in io.StringIO(text).read().splitlines() if ln.strip()]
    if not lines:
        raise CSVFormatError("empty file")
    rows = [ln.split(delimiter) for ln in lines]
    width = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) != width:
            raise CSVFormatError(f"row {i} has {len(r)} cells, expected {width}")
    return [c.strip() for c in rows[0]], [[c.strip() for c in r] for r in rows[1:]]


def fill_missing(values: np.ndarray) -> np.ndarray:
    """Paper: 'missing values were filled with zeroes'."""
    out = values.astype(np.float64, copy=True)
    out[~np.isfinite(out)] = 0.0
    return out


def scale_unit(x: np.ndarray, lo: Optional[np.ndarray] = None,
               hi: Optional[np.ndarray] = None):
    """Min-max scale each feature to [0, 1]. Constant features map to 0.
    Returns (scaled, lo, hi) so test data reuses train statistics."""
    lo = np.min(x, axis=0) if lo is None else lo
    hi = np.max(x, axis=0) if hi is None else hi
    span = hi - lo
    safe = np.where(span > 0, span, 1.0)
    scaled = np.clip((x - lo) / safe, 0.0, 1.0)
    scaled = np.where(span > 0, scaled, 0.0)
    return scaled, lo, hi


def one_hot_labels(labels: Sequence[str], classes: Optional[List[str]] = None):
    """One-hot encode categorical labels. Returns (onehot, classes)."""
    if classes is None:
        classes = sorted(set(map(str, labels)))
    index = {c: i for i, c in enumerate(classes)}
    oh = np.zeros((len(labels), len(classes)), np.float32)
    for i, lab in enumerate(labels):
        oh[i, index[str(lab)]] = 1.0
    return oh, classes


def train_test_split(x: np.ndarray, y: np.ndarray, *, test_frac: float = 0.2,
                     seed: int = 0):
    """Paper: '80% training and 20% testing'. Deterministic shuffle."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = int(round(n * test_frac))
    te, tr = perm[:n_test], perm[n_test:]
    return x[tr], y[tr], x[te], y[te]


def prepare(text: str, label: str, *, test_frac: float = 0.2,
            seed: int = 0) -> Dataset:
    """Full upload-to-dataset path: parse, select label, fill, scale, one-hot,
    split — the paper's stages 1-3 in one call."""
    header, rows = parse_csv(text)
    if label not in header:
        raise CSVFormatError(f"label column {label!r} not in header {header}")
    li = header.index(label)
    labels = [r[li] for r in rows]
    feat_names = [h for i, h in enumerate(header) if i != li]
    raw = np.array([[_to_float(c) for i, c in enumerate(r) if i != li]
                    for r in rows], np.float64)
    feats = fill_missing(raw)
    y, classes = one_hot_labels(labels)
    x_tr, y_tr, x_te, y_te = train_test_split(feats, y, test_frac=test_frac,
                                              seed=seed)
    x_tr, lo, hi = scale_unit(x_tr)
    x_te, _, _ = scale_unit(x_te, lo, hi)
    return Dataset(x_tr.astype(np.float32), y_tr, x_te.astype(np.float32),
                   y_te, classes, feat_names)


def _to_float(cell: str) -> float:
    if cell == "" or cell.lower() in ("nan", "null", "na"):
        return float("nan")
    try:
        return float(cell)
    except ValueError:
        # non-numeric feature cell: hash-bucket it deterministically; the
        # paper's datasets are "numerical features" so this is a tolerance,
        # not a codepath the experiments rely on.
        return float(hash(cell) % 1000) / 1000.0


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *, seed: int = 0,
            drop_remainder: bool = True):
    """Shuffled minibatch iterator (one epoch)."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, end, batch_size):
        sl = perm[i:i + batch_size]
        yield {"x": x[sl], "y": y[sl]}
