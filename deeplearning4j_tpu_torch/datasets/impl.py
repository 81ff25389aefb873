"""Concrete dataset iterators: MNIST, Iris, Digits, CIFAR-10, LFW,
Curves (port of deeplearning4j_tpu/datasets/impl.py).

MNIST reads the decompressed IDX files (``<name>.idx``) if they are
already in the local cache (``$DL4J_TPU_DATA_DIR/mnist``, else
``~/.deeplearning4j_tpu/mnist``), parsed in Python; the port fetches
nothing. Otherwise it makes the deterministic synthetic digit set of the
JAX package (`_synthetic_mnist`: the same arrays from the same seed).
CIFAR-10 reads its local binary batches, else synthetic images; LFW reads
a local image tree through `datasets/records.ImageRecordReader`, else
synthetic images. Iris / Digits come from scikit-learn's bundled
copies, imported when built.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import BaseDatasetIterator

MNIST_CACHE = Path(os.environ.get("DL4J_TPU_DATA_DIR",
                                  Path.home() / ".deeplearning4j_tpu")) / "mnist"
def _parse_idx(data: bytes) -> np.ndarray:
    """IDX format parser (reference: datasets/mnist/MnistDbFile.java)."""
    magic = struct.unpack(">I", data[:4])[0]
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def _read_cached(name: str) -> Optional[np.ndarray]:
    """The cached decompressed IDX file ``<name>.idx``, parsed, or None
    when it is absent or unreadable."""
    raw = MNIST_CACHE / f"{name}.idx"
    if not raw.exists():
        return None
    try:
        return _parse_idx(raw.read_bytes())
    except Exception:
        return None


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped synthetic digits: each class is a distinct
    low-frequency pattern plus noise, so small models can actually separate
    classes (lets integration tests assert accuracy improvements)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    protos = np.stack([np.sin((c + 1) * np.pi * xx)
                       * np.cos((c % 5 + 1) * np.pi * yy)
                       for c in range(10)])  # [10, 28, 28]
    labels = rng.randint(0, 10, size=n)
    imgs = protos[labels] * 0.5 + 0.5
    imgs = np.clip(imgs + rng.normal(0, 0.15, imgs.shape), 0, 1)
    return imgs.astype(np.float32), labels


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               allow_synthetic: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images [N, 28, 28] float32 in [0,1], labels [N] int,
    is_synthetic)."""
    prefix = "train" if train else "test"
    images = _read_cached(f"{prefix}_images")
    labels = _read_cached(f"{prefix}_labels")
    if images is not None and labels is not None:
        images = images.astype(np.float32) / 255.0
        synthetic = False
    else:
        if not allow_synthetic:
            raise RuntimeError(f"no MNIST IDX files in {MNIST_CACHE} and "
                               "synthetic data is disabled")
        n = num_examples or (60000 if train else 10000)
        images, labels = _synthetic_mnist(n, seed=42 if train else 43)
        synthetic = True
    if num_examples is not None:
        images = images[:num_examples]
        labels = labels[:num_examples]
    return images, np.asarray(labels), synthetic


class MnistDataSetIterator(BaseDatasetIterator):
    """MNIST minibatches: features [B, 784] float32 (the reference's
    flattened rows — pair with InputType.convolutional_flat(28, 28, 1)),
    labels one-hot [B, 10]."""

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 6,
                 shuffle: bool = True, allow_synthetic: bool = True):
        images, labels, synthetic = load_mnist(train, num_examples,
                                               allow_synthetic)
        self.synthetic = synthetic
        feats = images.reshape(images.shape[0], -1)
        onehot = np.eye(10, dtype=np.float32)[labels]
        if shuffle:
            rng = np.random.RandomState(seed)
            perm = rng.permutation(feats.shape[0])
            feats, onehot = feats[perm], onehot[perm]
        super().__init__(feats, onehot, batch_size)


class IrisDataSetIterator(BaseDatasetIterator):
    """Iris (reference: IrisDataSetIterator / IrisDataFetcher); data from
    scikit-learn's bundled copy."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 normalize: bool = True):
        from sklearn.datasets import load_iris
        data = load_iris()
        feats = data.data.astype(np.float32)[:num_examples]
        if normalize:
            feats = (feats - feats.mean(0)) / feats.std(0)
        labels = np.eye(3, dtype=np.float32)[data.target[:num_examples]]
        super().__init__(feats, labels, batch_size)


class DigitsDataSetIterator(BaseDatasetIterator):
    """8x8 handwritten digits from scikit-learn — a real, locally available
    stand-in for MNIST in CI."""

    def __init__(self, batch_size: int = 64, flatten: bool = True):
        from sklearn.datasets import load_digits
        data = load_digits()
        feats = (data.images / 16.0).astype(np.float32)
        if flatten:
            feats = feats.reshape(feats.shape[0], -1)
        else:
            feats = feats[..., None]  # NHWC
        labels = np.eye(10, dtype=np.float32)[data.target]
        super().__init__(feats, labels, batch_size)


def _synthetic_images(n: int, h: int, w: int, c: int, num_classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable synthetic images (same scheme as
    _synthetic_mnist, arbitrary geometry) for when no data is cached."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h - 1, 1)
    protos = np.stack([np.sin((k + 1) * np.pi * xx)
                       * np.cos((k % 5 + 1) * np.pi * yy)
                       for k in range(num_classes)])
    labels = rng.randint(0, num_classes, size=n)
    imgs = protos[labels][..., None] * 0.5 + 0.5
    imgs = np.broadcast_to(imgs, (n, h, w, c)).copy()
    imgs = np.clip(imgs + rng.normal(0, 0.15, imgs.shape), 0, 1)
    return imgs.astype(np.float32), labels


class CifarDataSetIterator(BaseDatasetIterator):
    """CIFAR-10 NHWC minibatches (reference: datasets/iterator/impl/
    CifarDataSetIterator.java + fetchers/CifarDataFetcher — binary-batch
    parse). Reads the local cache ($DL4J_TPU_DATA_DIR/cifar10/*.bin);
    without it, deterministic synthetic images with the same shapes
    (flagged via `.synthetic`)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 6,
                 allow_synthetic: bool = True):
        cache = Path(os.environ.get(
            "DL4J_TPU_DATA_DIR",
            Path.home() / ".deeplearning4j_tpu")) / "cifar10"
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        feats, labels = None, None
        if all((cache / f).exists() for f in files):
            raw_all, lab_all = [], []
            for f in files:
                buf = np.fromfile(cache / f, np.uint8)
                rows = buf.reshape(-1, 3073)
                lab_all.append(rows[:, 0])
                imgs = rows[:, 1:].reshape(-1, 3, 32, 32)
                raw_all.append(np.transpose(imgs, (0, 2, 3, 1))
                               .astype(np.float32) / 255.0)  # NHWC
            feats = np.concatenate(raw_all).astype(np.float32)
            labels = np.concatenate(lab_all).astype(np.int64)
            self.synthetic = False
        else:
            if not allow_synthetic:
                raise RuntimeError(
                    f"CIFAR-10 binaries not found in {cache} and synthetic "
                    "data is disabled")
            n = num_examples or (50000 if train else 10000)
            feats, labels = _synthetic_images(n, 32, 32, 3, 10,
                                              seed=44 if train else 45)
            self.synthetic = True
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        onehot = np.eye(10, dtype=np.float32)[labels]
        rng = np.random.RandomState(seed)
        perm = rng.permutation(feats.shape[0])
        super().__init__(feats[perm], onehot[perm], batch_size)


class LFWDataSetIterator(BaseDatasetIterator):
    """LFW faces (reference: datasets/iterator/impl/LFWDataSetIterator +
    fetchers/LFWDataFetcher). Reads a local image tree via
    ImageRecordReader ($DL4J_TPU_DATA_DIR/lfw/<person>/*.npy, or any
    image file where PIL is installed); otherwise synthetic image
    classes. Nothing is fetched."""

    def __init__(self, batch_size: int, height: int = 64, width: int = 64,
                 channels: int = 3, num_examples: Optional[int] = None,
                 num_classes: int = 10, seed: int = 6,
                 allow_synthetic: bool = True):
        root = Path(os.environ.get(
            "DL4J_TPU_DATA_DIR",
            Path.home() / ".deeplearning4j_tpu")) / "lfw"
        if root.is_dir() and any(root.iterdir()):
            from deeplearning4j_tpu_torch.datasets.records import \
                ImageRecordReader
            reader = ImageRecordReader(height, width, channels)
            reader.initialize(str(root))
            feats, labels = [], []
            for img, ci in reader.records():
                feats.append(img)
                labels.append(ci)
            feats = np.stack(feats)
            labels = np.asarray(labels)
            num_classes = len(reader.labels)
            self.synthetic = False
        else:
            if not allow_synthetic:
                raise RuntimeError(f"no LFW images under {root} and "
                                   "synthetic data is disabled")
            n = num_examples or 1000
            feats, labels = _synthetic_images(n, height, width, channels,
                                              num_classes, seed=46)
            self.synthetic = True
        if num_examples is not None:
            feats, labels = feats[:num_examples], labels[:num_examples]
        onehot = np.eye(num_classes, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size)


class CurvesDataSetIterator(BaseDatasetIterator):
    """Curves dataset (reference: datasets/fetchers/CurvesDataFetcher +
    iterator/CurvesDataSetIterator — 784-dim curve images used for deep
    autoencoder pretraining; labels == features, i.e. reconstruction
    targets). The reference downloads curves.ser; here
    curves are synthesized deterministically: random cubic Bézier
    strokes rasterized to 28x28, matching the original data's shape and
    use."""

    def __init__(self, batch_size: int = 128, num_examples: int = 1000,
                 seed: int = 12):
        rng = np.random.RandomState(seed)
        h = w = 28
        feats = np.zeros((num_examples, h, w), dtype=np.float32)
        t = np.linspace(0.0, 1.0, 64)[:, None]
        bez = np.concatenate([(1 - t) ** 3, 3 * (1 - t) ** 2 * t,
                              3 * (1 - t) * t ** 2, t ** 3], axis=1)
        for i in range(num_examples):
            ctrl = rng.uniform(3, w - 4, size=(4, 2))
            pts = bez @ ctrl  # [64, 2] points along the curve
            xi = np.clip(np.round(pts[:, 0]).astype(int), 0, w - 1)
            yi = np.clip(np.round(pts[:, 1]).astype(int), 0, h - 1)
            feats[i, yi, xi] = 1.0
        flat = feats.reshape(num_examples, h * w)
        super().__init__(flat, flat.copy(), batch_size)
