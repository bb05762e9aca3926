"""Dataset loading for the logistic-regression, BNN and Talos targets.

(JAX counterpart: gmmvi_tpu/experiments/targets/datasets.py)

The UCI data files, the wine splits and the Talos URDF ship with the JAX package, under
``gmmvi_tpu/experiments/targets/datasets/``; the port reads them in place
(a path built from this file's location, not an import of that package).
A directory named by the ``GMMVI_DATASETS`` environment variable is
searched first, as in the JAX package.  MNIST's ``mnist.npz`` is not in the
repository: it is read from those two places, or from the keras download
cache ``~/.keras/datasets/mnist.npz`` (a local file; nothing is
downloaded).

A missing file raises FileNotFoundError naming the paths searched.  With
``GMMVI_ALLOW_SYNTHETIC=1`` the breast-cancer, german-credit, wine and
MNIST loaders instead warn and return the JAX package's deterministic
stand-in of the same shapes, drawn as it draws them (so both packages get
the same arrays); a run on a stand-in is not a reproduction of the
experiment.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

DATA_DIR = (Path(__file__).resolve().parents[3] / "gmmvi_tpu" / "experiments"
            / "targets" / "datasets")
SYNTHETIC_ENV = "GMMVI_ALLOW_SYNTHETIC"


def _search_paths(filename: str) -> List[Path]:
    env = os.environ.get("GMMVI_DATASETS")
    return ([Path(env) / filename] if env else []) + [DATA_DIR / filename]


def _not_found(filename: str, paths: List[Path]) -> FileNotFoundError:
    return FileNotFoundError(
        f"dataset '{filename}' not found at {', '.join(map(str, paths))}; "
        f"set GMMVI_DATASETS to a directory holding it (or {SYNTHETIC_ENV}=1 "
        "for the synthetic stand-in, which is not the experiment's data)")


def _first_existing(paths: List[Path]) -> Optional[Path]:
    return next((p for p in paths if p.exists()), None)


def find(filename: str) -> Path:
    """The first existing ``filename`` on the search path; raises
    FileNotFoundError naming every path tried."""
    paths = _search_paths(filename)
    found = _first_existing(paths)
    if found is None:
        raise _not_found(filename, paths)
    return found


def _missing(name: str, filename: str, paths: List[Path]) -> None:
    """Return (after a warning) where ``GMMVI_ALLOW_SYNTHETIC=1`` allows
    the stand-in, else raise FileNotFoundError naming ``paths``."""
    if os.environ.get(SYNTHETIC_ENV) != "1":
        raise _not_found(filename, paths)
    warnings.warn(f"{name} dataset unavailable; using synthetic stand-in")


def _synthetic_classification(n: int, f: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, f))
    w = rng.standard_normal(f)
    p = 1.0 / (1.0 + np.exp(-(x @ w) / np.sqrt(f)))
    y = (rng.random(n) < p).astype(np.float64)
    return x, y


def load_breast_cancer() -> Tuple[np.ndarray, np.ndarray]:
    """UCI WDBC: (X [569, 30], labels [569]) from ``breast_cancer.data``
    (id, label, 30 features); labels 0 = malignant."""
    paths = _search_paths("breast_cancer.data")
    p = _first_existing(paths)
    if p is not None:
        data = np.loadtxt(str(p))
        return data[:, 2:], data[:, 1]
    _missing("breast_cancer", "breast_cancer.data", paths)
    return _synthetic_classification(569, 30, seed=0)


def load_german_credit() -> Tuple[np.ndarray, np.ndarray]:
    """UCI German credit, numeric: (X [1000, 24], labels in {0, 1}) from
    ``german.data-numeric``, whose last column is the label in {1, 2}."""
    paths = _search_paths("german.data-numeric")
    p = _first_existing(paths)
    if p is not None:
        data = np.loadtxt(str(p))
        return data[:, :-1], data[:, -1] - 1
    _missing("german_credit", "german.data-numeric", paths)
    return _synthetic_classification(1000, 24, seed=1)


def load_wine_split(dataset_seed: int) -> Dict[str, np.ndarray]:
    """The wine-quality regression split ``wine/wine_seed_{seed % 10}.npz``:
    ``features_{train,vali,test}`` (standardized, 11 columns) and
    ``labels_{train,vali,test}``, as stored."""
    fname = os.path.join("wine", f"wine_seed_{dataset_seed % 10}.npz")
    paths = _search_paths(fname)
    p = _first_existing(paths)
    if p is not None:
        d = np.load(str(p))
        return {k: np.asarray(d[k]) for k in d.files}
    _missing("wine", fname, paths)
    rng = np.random.RandomState(1234 + dataset_seed % 10)
    n, f = 4898, 11
    x = rng.standard_normal((n, f))
    w = rng.standard_normal(f)
    y = x @ w * 0.5 + 6.0 + 0.7 * rng.standard_normal(n)
    x = (x - x.mean(0)) / x.std(0)
    tr, te = int(n * 0.6), int(n * 0.2)
    return {
        "features_train": x[:tr].astype(np.float32),
        "features_test": x[tr:tr + te].astype(np.float32),
        "features_vali": x[tr + te:].astype(np.float32),
        "labels_train": y[:tr].astype(np.float32),
        "labels_test": y[tr:tr + te].astype(np.float32),
        "labels_vali": y[tr + te:].astype(np.float32),
    }


def _mnist_from_npz(d) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """(train_x, train_y, test_x, test_y) from either schema of
    ``mnist.npz``: the flat ``train_x [N, 784]`` in [0, 1] as stored, or
    the keras archive's ``x_train [N, 28, 28]`` uint8, scaled by 1/255 and
    flattened."""
    keys = d.files if hasattr(d, "files") else d.keys()
    if "train_x" in keys:
        return d["train_x"], d["train_y"], d["test_x"], d["test_y"]

    def to_flat(x):
        return (np.asarray(x, np.float32) / 255.0).reshape(x.shape[0], -1)

    return (to_flat(d["x_train"]), np.asarray(d["y_train"]),
            to_flat(d["x_test"]), np.asarray(d["y_test"]))


def mnist_paths() -> List[Path]:
    """Where ``mnist.npz`` is looked for, in order: ``GMMVI_DATASETS``,
    the data directory, the keras download cache."""
    return _search_paths("mnist.npz") + [
        Path.home() / ".keras" / "datasets" / "mnist.npz"]


def load_mnist() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_x [N, 784], train_y, test_x, test_y), pixels in [0, 1], from
    the first ``mnist.npz`` of :func:`mnist_paths`; with
    ``GMMVI_ALLOW_SYNTHETIC=1`` and no file, the JAX package's stand-in:
    6,000 training and 1,000 test images of uniform pixels with uniform
    labels in 0..9, from ``np.random.RandomState(42)``."""
    paths = mnist_paths()
    p = _first_existing(paths)
    if p is not None:
        with np.load(str(p), allow_pickle=True) as d:
            return _mnist_from_npz(d)
    _missing("mnist", "mnist.npz", paths)
    rng = np.random.RandomState(42)
    n_tr, n_te = 6000, 1000
    x_tr = rng.random((n_tr, 784)).astype(np.float32)
    x_te = rng.random((n_te, 784)).astype(np.float32)
    y_tr = rng.randint(0, 10, n_tr)
    y_te = rng.randint(0, 10, n_te)
    return x_tr, y_tr, x_te, y_te
