"""L0 — the MNIST-embedding loader of BASELINE config 4 (numpy only).

A copy of the MNIST half of ``tuplewise_tpu.data.loaders``, so that the
port reads the same files and, with nothing on disk, builds the same
deterministic surrogate bit for bit. It looks, in order, for a
``path=`` npz, ``mnist_embeddings.npz`` (keys ``E``, ``labels``) and the
canonical raw IDX pair ``train-images-idx3-ubyte[.gz]`` /
``train-labels-idx1-ubyte[.gz]`` (embedded by a deterministic PCA
projection) under ``TUPLEWISE_DATA_DIR``; with none of them it generates
class-clustered embeddings, marked ``meta["synthetic"]``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_MNIST_EMB_DIM = 32
_MNIST_CLASSES = 10


def _data_dir() -> str:
    return os.environ.get("TUPLEWISE_DATA_DIR",
                          os.path.join(os.path.dirname(__file__), "_cache"))


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
