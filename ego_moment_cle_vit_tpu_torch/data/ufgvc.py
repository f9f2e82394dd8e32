"""UFGVC parquet datasets (cotton80, soybean, soy_ageing_R*).

The port's copy of ``ego_moment_cle_vit_tpu/data/ufgvc.py``: the seven
registered datasets with their HuggingFace parquet URLs, the streaming
download (copied, run only when a file is missing and ``download`` is set),
split filtering, sorted class indexing and the info API.

``__getitem__`` decodes the JPEG bytes and resizes to ``resize_size`` on the
host and returns uint8 HWC numpy; every augmentation runs on the device
(``data/augment.py``).  ``SyntheticUFGDataset`` has the same surface and
needs no file.  ``pyarrow``, ``PIL``, ``requests`` and ``pandas`` are imported
inside the functions that use them.
"""

from __future__ import annotations

import io
import os
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

_HF_BASE = (
    "https://huggingface.co/datasets/hibana2077/CV-dataset-all-in-parquet/"
    "resolve/main/datasets/ufgvc"
)

DATASETS: Dict[str, Dict[str, str]] = {
    "cotton80": {
        "url": f"{_HF_BASE}/cotton80_dataset.parquet?download=true",
        "filename": "cotton80_dataset.parquet",
        "description": "Cotton classification dataset with 80 classes",
    },
    "soybean": {
        "url": f"{_HF_BASE}/soybean_dataset.parquet?download=true",
        "filename": "soybean_dataset.parquet",
        "description": "Soybean classification dataset",
    },
    **{
        f"soy_ageing_r{r}": {
            "url": f"{_HF_BASE}/soy_ageing_R{r}_dataset.parquet?download=true",
            "filename": f"soy_ageing_R{r}_dataset.parquet",
            "description": f"Soybean ageing dataset - Round {r}",
        }
        for r in (1, 3, 4, 5, 6)
    },
}


class UFGVCDataset:
    """Map-style dataset over one UFG parquet file.

    Parquet schema: columns {image: bytes, label, class_name, split}.
    """

    DATASETS = DATASETS

    def __init__(
        self,
        dataset_name: str = "cotton80",
        root: str = "./data",
        split: str = "train",
        resize_size: Optional[int] = None,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
        download: bool = True,
    ):
        if dataset_name not in DATASETS:
            raise ValueError(
                f"Dataset '{dataset_name}' not found. Available datasets: "
                f"{list(DATASETS)}"
            )
        self.dataset_name = dataset_name
        self.dataset_config = DATASETS[dataset_name]
        self.root = Path(root)
        self.split = split
        self.resize_size = resize_size
        self.transform = transform
        self.target_transform = target_transform

        self.url = self.dataset_config["url"]
        self.filename = self.dataset_config["filename"]
        self.filepath = self.root / self.filename
        self.root.mkdir(parents=True, exist_ok=True)

        if download and not self.filepath.exists():
            self._download()
        self._load()

    # -- IO ------------------------------------------------------------------

    def _download(self) -> None:
        """Streaming download with progress; removes the partial file on any
        failure."""
        import requests

        print(
            f"Downloading {self.dataset_name}: "
            f"{self.dataset_config['description']} -> {self.filepath}"
        )
        try:
            with requests.get(self.url, stream=True, timeout=60) as resp:
                resp.raise_for_status()
                total = int(resp.headers.get("content-length", 0))
                done = 0
                with open(self.filepath, "wb") as f:
                    for chunk in resp.iter_content(chunk_size=1 << 20):
                        if chunk:
                            f.write(chunk)
                            done += len(chunk)
                            if total:
                                print(
                                    f"\rProgress: {100.0 * done / total:.1f}%",
                                    end="",
                                )
            print(f"\nDownload complete: {self.filepath}")
        except Exception as exc:
            if self.filepath.exists():
                self.filepath.unlink()
            raise RuntimeError(
                f"Failed to download {self.dataset_name}: {exc}"
            ) from exc

    def _load(self) -> None:
        if not self.filepath.exists():
            raise FileNotFoundError(f"Dataset file not found: {self.filepath}")
        import pyarrow.parquet as pq

        table = pq.read_table(self.filepath)
        needed = {"image", "label", "class_name", "split"}
        missing = needed - set(table.column_names)
        if missing:
            raise ValueError(f"Missing columns: {missing}")

        splits = table.column("split").to_pylist()
        keep = [i for i, s in enumerate(splits) if s == self.split]
        if not keep:
            raise ValueError(
                f"No data found for split '{self.split}'. Available splits: "
                f"{sorted(set(splits))}"
            )
        sub = table.take(keep)
        self._images: List[bytes] = sub.column("image").to_pylist()
        self._labels = np.asarray(sub.column("label").to_pylist(), np.int64)
        self._class_names: List[str] = sub.column("class_name").to_pylist()

        self.classes = sorted(set(self._class_names))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.num_classes = len(self.classes)

    # -- access --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._images)

    def decode_image(self, idx: int) -> "Any":
        """Decode sample ``idx`` to a PIL RGB image."""
        from PIL import Image

        return Image.open(io.BytesIO(self._images[idx])).convert("RGB")

    def __getitem__(self, idx: int) -> Tuple[Any, int]:
        if idx >= len(self):
            raise IndexError(
                f"Index {idx} out of range for dataset of size {len(self)}"
            )
        img = self.decode_image(idx)
        if self.resize_size is not None:
            img = img.resize((self.resize_size, self.resize_size))
        # index via class_to_idx, NOT the raw parquet label: the head is
        # sized from len(self.classes) (split-local sorted names), and raw
        # ids that disagree with that order would silently one_hot to
        # all-zero targets / misattribute per-class metrics
        label = self.class_to_idx[self._class_names[idx]]
        if self.transform is not None:
            out = self.transform(img)
        else:
            out = np.asarray(img, np.uint8)
        if self.target_transform is not None:
            label = self.target_transform(label)
        return out, label

    def get_class_name(self, idx: int) -> str:
        return self._class_names[idx]

    # -- introspection ---------------------------------------------------------

    def get_dataset_info(self) -> dict:
        import pyarrow.parquet as pq

        table = pq.read_table(self.filepath, columns=["split", "class_name"])
        splits = table.column("split").to_pylist()
        split_counts: Dict[str, int] = {}
        for s in splits:
            split_counts[s] = split_counts.get(s, 0) + 1
        return {
            "dataset_name": self.dataset_name,
            "description": self.dataset_config["description"],
            "current_split": self.split,
            "current_samples": len(self),
            "current_classes": self.num_classes,
            "total_samples": len(splits),
            "total_classes": len(set(table.column("class_name").to_pylist())),
            "split_distribution": split_counts,
            "classes": self.classes,
            "filepath": str(self.filepath),
        }

    def get_sample_info(self, idx: int) -> dict:
        return {
            "dataset": self.dataset_name,
            "index": idx,
            "label": int(self._labels[idx]),
            "class_name": self._class_names[idx],
            "split": self.split,
        }

    @classmethod
    def list_available_datasets(cls) -> Dict[str, str]:
        return {name: cfg["description"] for name, cfg in DATASETS.items()}

    @classmethod
    def get_dataset_splits(cls, dataset_name: str, root: str = "./data") -> list:
        if dataset_name not in DATASETS:
            raise ValueError(f"Dataset '{dataset_name}' not found")
        filepath = Path(root) / DATASETS[dataset_name]["filename"]
        if not filepath.exists():
            print("Dataset file not found. Splits unknown until downloaded.")
            return []
        import pyarrow.parquet as pq

        splits = pq.read_table(filepath, columns=["split"]).column("split")
        return sorted(set(splits.to_pylist()))


class SyntheticUFGDataset:
    """Drop-in UFGVCDataset stand-in with deterministic random JPEG-free
    samples — for tests, zero-egress environments, and benchmarks.

    Same access surface: __len__/__getitem__/classes/class_to_idx/
    num_classes/get_dataset_info.
    """

    def __init__(
        self,
        num_classes: int = 80,
        samples_per_class: int = 9,
        image_size: int = 600,
        split: str = "train",
        seed: int = 0,
        resize_size: Optional[int] = None,
        learnable: bool = False,
    ):
        """``learnable=True`` embeds a class-dependent signal (per-class
        color tint + spatial frequency pattern) under the noise, so training
        sanity checks can verify accuracy actually climbs above chance."""
        self.dataset_name = "synthetic"
        self.split = split
        self.image_size = resize_size or image_size
        self.num_classes = num_classes
        self.learnable = learnable
        self.classes = [f"class_{i:03d}" for i in range(num_classes)]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self._labels = np.repeat(np.arange(num_classes), samples_per_class)
        import zlib

        # stable across processes (hash() is PYTHONHASHSEED-randomized,
        # which would break the documented determinism)
        self._seed = seed + (zlib.crc32(split.encode()) % 1000)

    def __len__(self) -> int:
        return len(self._labels)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng(self._seed * 100003 + idx)
        label = int(self._labels[idx])
        s = self.image_size
        if not self.learnable:
            img = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
            return img, label
        # class signal: tint + low-frequency grating, + strong noise.  Tints
        # sit on a maximally separated color circle (pairwise channel
        # distance >> noise sigma) — randomly drawn tints can collide within
        # the noise for nearby labels, capping accuracy below memorization
        # and making the learning tests flaky.
        crng = np.random.default_rng(9999 + label)
        ang = 2.0 * np.pi * label / max(self.num_classes, 1)
        tint = 128.0 + 80.0 * np.cos(
            ang + np.array([0.0, 2.0 * np.pi / 3.0, 4.0 * np.pi / 3.0])
        )
        freq = crng.uniform(1.5, 6.0)
        phase = crng.uniform(0, 2 * np.pi)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        grating = 40.0 * np.sin(2 * np.pi * freq * (xx + yy) + phase)
        noise = rng.normal(0.0, 35.0, (s, s, 3))
        img = tint[None, None, :] + grating[..., None] + noise
        return np.clip(img, 0, 255).astype(np.uint8), label

    def get_dataset_info(self) -> dict:
        return {
            "dataset_name": self.dataset_name,
            "description": "Synthetic random dataset (zero-egress testing)",
            "current_split": self.split,
            "current_samples": len(self),
            "current_classes": self.num_classes,
            "total_samples": len(self),
            "total_classes": self.num_classes,
            "split_distribution": {self.split: len(self)},
            "classes": self.classes,
            "filepath": "<synthetic>",
        }


def compare_datasets(dataset_names: list, root: str = "./data"):
    """Summary table across datasets.  Returns a pandas DataFrame."""
    import pandas as pd

    rows = []
    for name in dataset_names:
        try:
            ds = UFGVCDataset(dataset_name=name, root=root, download=True)
            info = ds.get_dataset_info()
            rows.append(
                {
                    "Dataset": name,
                    "Description": info["description"],
                    "Total Samples": info["total_samples"],
                    "Total Classes": info["total_classes"],
                    "Train Samples": info["split_distribution"].get("train", 0),
                    "Val Samples": info["split_distribution"].get("val", 0),
                    "Test Samples": info["split_distribution"].get("test", 0),
                    "Available Splits": list(info["split_distribution"]),
                }
            )
        except Exception as exc:  # pragma: no cover - network dependent
            print(f"Error loading {name}: {exc}")
    return pd.DataFrame(rows)
