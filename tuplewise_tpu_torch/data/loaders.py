"""L0 — the dataset loaders of BASELINE configs 2 and 4 (numpy only).

A copy of ``tuplewise_tpu.data.loaders``, so that the port reads the same
files and, with nothing on disk, builds the same deterministic
surrogates bit for bit.

* UCI Adult (config 2, bipartite ranking): ``load_adult`` looks for a
  ``path=`` file, then ``adult.npz`` (keys ``X``, ``y``), then the
  canonical ``adult.data`` / ``adult.csv`` CSV (``parse_adult_csv``:
  rows with '?' dropped, categoricals one-hot against the canonical UCI
  vocabulary) under ``TUPLEWISE_DATA_DIR``.
* MNIST embeddings (config 4): a ``path=`` npz, ``mnist_embeddings.npz``
  (keys ``E``, ``labels``), then the canonical raw IDX pair
  ``train-images-idx3-ubyte[.gz]`` / ``train-labels-idx1-ubyte[.gz]``
  (embedded by a deterministic PCA projection).

With no file on disk each builds a deterministic synthetic surrogate of
the same schema, marked ``meta["synthetic"]``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_MNIST_EMB_DIM = 32
_MNIST_CLASSES = 10
_ADULT_DIM = 14  # UCI Adult: 6 continuous + 8 categorical attributes

# adult.data column schema (UCI census-income): position -> continuous?
_ADULT_CONTINUOUS = (0, 2, 4, 10, 11, 12)   # age, fnlwgt, education-num,
#                                             capital-gain/loss, hours/week
_ADULT_N_COLS = 15                           # 14 attributes + label

# Canonical category sets per the UCI adult.names spec, sorted. Encoding
# against the FULL canonical vocabulary (not the categories that happen
# to appear in one file) keeps the design matrix aligned across
# adult.data and adult.test — e.g. 'Holand-Netherlands' occurs once in
# adult.data and never in adult.test; a per-file vocabulary would shift
# every later one-hot column between the two.
_ADULT_CATEGORIES = {
    1: (  # workclass
        "Federal-gov", "Local-gov", "Never-worked", "Private",
        "Self-emp-inc", "Self-emp-not-inc", "State-gov", "Without-pay",
    ),
    3: (  # education
        "10th", "11th", "12th", "1st-4th", "5th-6th", "7th-8th", "9th",
        "Assoc-acdm", "Assoc-voc", "Bachelors", "Doctorate", "HS-grad",
        "Masters", "Preschool", "Prof-school", "Some-college",
    ),
    5: (  # marital-status
        "Divorced", "Married-AF-spouse", "Married-civ-spouse",
        "Married-spouse-absent", "Never-married", "Separated", "Widowed",
    ),
    6: (  # occupation
        "Adm-clerical", "Armed-Forces", "Craft-repair", "Exec-managerial",
        "Farming-fishing", "Handlers-cleaners", "Machine-op-inspct",
        "Other-service", "Priv-house-serv", "Prof-specialty",
        "Protective-serv", "Sales", "Tech-support", "Transport-moving",
    ),
    7: (  # relationship
        "Husband", "Not-in-family", "Other-relative", "Own-child",
        "Unmarried", "Wife",
    ),
    8: (  # race
        "Amer-Indian-Eskimo", "Asian-Pac-Islander", "Black", "Other",
        "White",
    ),
    9: ("Female", "Male"),  # sex
    13: (  # native-country
        "Cambodia", "Canada", "China", "Columbia", "Cuba",
        "Dominican-Republic", "Ecuador", "El-Salvador", "England",
        "France", "Germany", "Greece", "Guatemala", "Haiti",
        "Holand-Netherlands", "Honduras", "Hong", "Hungary", "India",
        "Iran", "Ireland", "Italy", "Jamaica", "Japan", "Laos", "Mexico",
        "Nicaragua", "Outlying-US(Guam-USVI-etc)", "Peru", "Philippines",
        "Poland", "Portugal", "Puerto-Rico", "Scotland", "South",
        "Taiwan", "Thailand", "Trinadad&Tobago", "United-States",
        "Vietnam", "Yugoslavia",
    ),
}


def _data_dir() -> str:
    return os.environ.get("TUPLEWISE_DATA_DIR",
                          os.path.join(os.path.dirname(__file__), "_cache"))


def parse_adult_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse the canonical ``adult.data`` / ``adult.test`` CSV.

    Schema: 6 continuous + 8 categorical attributes, comma-separated
    with a ``<=50K`` / ``>50K`` label (trailing '.' in adult.test).
    Rows containing missing values ('?') are dropped — the standard
    preprocessing for this dataset. Categoricals are one-hot encoded
    against the CANONICAL UCI vocabulary (``_ADULT_CATEGORIES``), so
    adult.data and adult.test yield identically laid-out design
    matrices even though some categories appear in only one file. A
    column whose values fall outside the canonical set (toy fixtures)
    falls back to that file's own sorted categories.

    Returns (X [n, d] float64 un-standardized, y [n] int {0, 1}).
    """
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().rstrip(".").split(",")]
            if len(parts) != _ADULT_N_COLS or "?" in parts:
                continue
            rows.append(parts)
    if not rows:
        raise ValueError(f"no parseable rows in {path!r}")
    cols = list(zip(*rows))
    blocks = []
    for c in range(_ADULT_N_COLS - 1):
        if c in _ADULT_CONTINUOUS:
            blocks.append(np.asarray(cols[c], float)[:, None])
        else:
            seen = set(cols[c])
            canon = _ADULT_CATEGORIES[c]
            if seen <= set(canon):
                cats = canon
            else:
                # out-of-vocabulary values: this file gets its OWN
                # vocabulary for the column, which breaks alignment
                # with any canonically-encoded file — say so loudly.
                import warnings

                warnings.warn(
                    f"{path!r} column {c}: non-canonical categories "
                    f"{sorted(seen - set(canon))!r}; using a file-local "
                    f"vocabulary (design matrix will NOT align with "
                    f"canonically-encoded adult files)",
                    stacklevel=2,
                )
                cats = tuple(sorted(seen))
            code = {v: k for k, v in enumerate(cats)}
            idx = np.asarray([code[v] for v in cols[c]])
            onehot = np.zeros((len(idx), len(cats)))
            onehot[np.arange(len(idx)), idx] = 1.0
            blocks.append(onehot)
    X = np.concatenate(blocks, axis=1)
    y = np.asarray([1 if v.startswith(">50K") else 0 for v in cols[-1]])
    return X, y


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX-format file (the canonical MNIST distribution
    format), gunzipping ``.gz``. Magic: 2 zero bytes, dtype code (0x08 =
    uint8), ndim, then ndim big-endian u32 dims."""
    opener = gzip.open if path.endswith(".gz") else open

    def read_exact(f, k):
        buf = f.read(k)
        if len(buf) != k:
            raise ValueError(
                f"{path!r}: truncated IDX header "
                f"(wanted {k} bytes, got {len(buf)})"
            )
        return buf

    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", read_exact(f, 4))
        if zero != 0 or dtype_code != 0x08:
            raise ValueError(
                f"{path!r} is not a uint8 IDX file "
                f"(magic {zero:#x}/{dtype_code:#x})"
            )
        dims = struct.unpack(f">{ndim}I", read_exact(f, 4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path!r}: payload {data.size} != header dims {dims}")
    return data.reshape(dims)


def _find_idx_pair(dirs) -> Optional[Tuple[str, str]]:
    for d in dirs:
        for suffix in ("", ".gz"):
            imgs = os.path.join(d, f"train-images-idx3-ubyte{suffix}")
            labs = os.path.join(d, f"train-labels-idx1-ubyte{suffix}")
            if os.path.exists(imgs) and os.path.exists(labs):
                return imgs, labs
    return None


def mnist_pca_embeddings(images: np.ndarray,
                         dim: int = _MNIST_EMB_DIM) -> np.ndarray:
    """Deterministic PCA embedding of raw [n, 28, 28] uint8 images:
    center, project onto the top ``dim`` eigenvectors of the pixel
    covariance (sign-fixed: the largest-|component| entry of each PC is
    positive), scale to unit average norm."""
    flat = images.reshape(len(images), -1).astype(np.float64) / 255.0
    mu = flat.mean(axis=0)
    centered = flat - mu
    cov = centered.T @ centered / len(flat)
    vals, vecs = np.linalg.eigh(cov)
    top = vecs[:, np.argsort(vals)[::-1][:dim]]
    signs = np.sign(top[np.argmax(np.abs(top), axis=0), np.arange(dim)])
    E = centered @ (top * signs)
    return E / (np.linalg.norm(E, axis=1).mean() + 1e-12)


def load_adult(
    path: Optional[str] = None,
    n: int = 32561,
    seed: int = 0,
    standardize: bool = True,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """UCI Adult as a binary task: features, labels in {0, 1}.

    Returns (X [n, d] float64 standardized, y [n] int, meta); pass
    ``standardize=False`` for raw features (the train/test split path
    standardizes with train-side statistics instead — see
    :mod:`tuplewise_tpu_torch.data.splits`). Real-data
    resolution order: ``path=`` (either format) -> ``adult.npz`` (keys
    ``X``, ``y``) -> the canonical ``adult.data``/``adult.csv`` CSV
    parsed by :func:`parse_adult_csv`. With nothing on disk, generates
    a deterministic surrogate: a mixture where the positive class
    (~24%, the real Adult positive rate) is shifted along a random
    direction with heterogeneous per-feature scales — enough structure
    for ranking experiments.
    """
    candidates = [path] if path else []
    candidates += [
        os.path.join(_data_dir(), f)
        for f in ("adult.npz", "adult.data", "adult.csv")
    ]
    for c in candidates:
        if not (c and os.path.exists(c)):
            continue
        if c.endswith(".npz"):
            blob = np.load(c)
            X, y = np.asarray(blob["X"], float), np.asarray(blob["y"], int)
        else:
            X, y = parse_adult_csv(c)
        if len(X) > n:  # honor the requested size on real data too
            keep = np.random.default_rng(seed).choice(len(X), n, replace=False)
            X, y = X[keep], y[keep]
        if standardize:
            X = (X - X.mean(0)) / (X.std(0) + 1e-12)
        return X, y, {"synthetic": False, "source": c}

    rng = np.random.default_rng(seed + 1043)
    d = _ADULT_DIM
    pos_rate = 0.2408
    y = (rng.random(n) < pos_rate).astype(int)
    scales = rng.uniform(0.5, 2.0, size=d)
    direction = rng.standard_normal(d)
    direction /= np.linalg.norm(direction)
    X = rng.standard_normal((n, d)) * scales
    # Mild nonlinear class structure: shift + a curved component.
    X[y == 1] += 1.2 * direction * scales
    X[y == 1, 0] += 0.3 * X[y == 1, 1] ** 2 * 0.1
    if standardize:
        X = (X - X.mean(0)) / (X.std(0) + 1e-12)
    return X, y, {"synthetic": True, "source": "surrogate(adult)"}


def load_mnist_embeddings(
    path: Optional[str] = None,
    n: int = 10000,
    dim: int = _MNIST_EMB_DIM,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """MNIST embeddings for the triplet statistics: (E [n, dim] float64,
    labels [n] int in [0, 10), meta). Real data (see the module
    docstring) is subsampled to n rows with ``default_rng(seed)``; the
    surrogate is 10 class centroids (scale 2) plus 0.6 intra-class
    noise, drawn from ``default_rng(seed + 60283)``."""
    candidates = [path] if path else []
    candidates.append(os.path.join(_data_dir(), "mnist_embeddings.npz"))
    for c in candidates:
        if c and os.path.exists(c):
            blob = np.load(c)
            E = np.asarray(blob["E"], float)
            labels = np.asarray(blob["labels"], int)
            if len(E) > n:
                keep = np.random.default_rng(seed).choice(len(E), n,
                                                          replace=False)
                E, labels = E[keep], labels[keep]
            return E, labels, {"synthetic": False, "source": c}

    idx = _find_idx_pair([_data_dir()])
    if idx is not None:
        imgs, labs = idx
        images = _read_idx(imgs)
        labels = _read_idx(labs).astype(int)
        if images.ndim != 3 or len(images) != len(labels):
            raise ValueError(
                f"IDX pair mismatch: images {images.shape}, "
                f"labels {labels.shape}"
            )
        if len(images) > n:
            keep = np.random.default_rng(seed).choice(len(images), n,
                                                      replace=False)
            images, labels = images[keep], labels[keep]
        E = mnist_pca_embeddings(images, dim=min(dim, images[0].size))
        return E, labels, {"synthetic": False, "source": imgs}

    rng = np.random.default_rng(seed + 60283)
    centroids = rng.standard_normal((_MNIST_CLASSES, dim)) * 2.0
    labels = rng.integers(0, _MNIST_CLASSES, size=n)
    E = centroids[labels] + 0.6 * rng.standard_normal((n, dim))
    return E, labels, {"synthetic": True, "source": "surrogate(mnist-emb)"}
