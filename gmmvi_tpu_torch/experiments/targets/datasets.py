"""Dataset loading for the logistic-regression, BNN and Talos targets.

(JAX counterpart: gmmvi_tpu/experiments/targets/datasets.py, the
breast-cancer, german-credit and wine loaders)

The UCI data files, the wine splits and the Talos URDF ship with the JAX package, under
``gmmvi_tpu/experiments/targets/datasets/``; the port reads them in place
(a path built from this file's location, not an import of that package).
A directory named by the ``GMMVI_DATASETS`` environment variable is
searched first, as in the JAX package.  A missing file raises
FileNotFoundError naming the paths searched.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

DATA_DIR = (Path(__file__).resolve().parents[3] / "gmmvi_tpu" / "experiments"
            / "targets" / "datasets")


def _search_paths(filename: str) -> List[Path]:
    env = os.environ.get("GMMVI_DATASETS")
    return ([Path(env) / filename] if env else []) + [DATA_DIR / filename]


def find(filename: str) -> Path:
    """The first existing ``filename`` on the search path; raises
    FileNotFoundError naming every path tried."""
    paths = _search_paths(filename)
    for p in paths:
        if p.exists():
            return p
    raise FileNotFoundError(
        f"dataset '{filename}' not found at {', '.join(map(str, paths))}; "
        "set GMMVI_DATASETS to a directory holding it")


def load_breast_cancer() -> Tuple[np.ndarray, np.ndarray]:
    """UCI WDBC: (X [569, 30], labels [569]) from ``breast_cancer.data``
    (id, label, 30 features); labels 0 = malignant."""
    data = np.loadtxt(str(find("breast_cancer.data")))
    return data[:, 2:], data[:, 1]


def load_german_credit() -> Tuple[np.ndarray, np.ndarray]:
    """UCI German credit, numeric: (X [1000, 24], labels in {0, 1}) from
    ``german.data-numeric``, whose last column is the label in {1, 2}."""
    data = np.loadtxt(str(find("german.data-numeric")))
    return data[:, :-1], data[:, -1] - 1


def load_wine_split(dataset_seed: int) -> Dict[str, np.ndarray]:
    """The wine-quality regression split ``wine/wine_seed_{seed % 10}.npz``:
    ``features_{train,vali,test}`` (standardized, 11 columns) and
    ``labels_{train,vali,test}``, as stored."""
    d = np.load(str(find(os.path.join("wine",
                                      f"wine_seed_{dataset_seed % 10}.npz"))))
    return {k: np.asarray(d[k]) for k in d.files}
