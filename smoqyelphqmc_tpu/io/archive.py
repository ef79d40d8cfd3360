"""Measurement archives: NumPy .npz files laid out like a small HDF5 tree.

Every array sits under a path-like key. "category/name" is a dataset,
"category/name@attr" is an attribute of that dataset, and "@attr" is an
attribute of the whole file. Only this module knows the layout: the writers in
io/measurements_io.py and the readers in io/correlation_ratio.py and the tests
go through `save`, `load`, `datasets` and `attrs`."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

EXT = ".npz"


def save(path: str, entries: Mapping[str, object]) -> None:
    """Write `entries` (key -> array-like) to `path`, which ends in .npz."""
    if not path.endswith(EXT):
        raise ValueError(f"archive path must end in {EXT}: {path}")
    np.savez(path, **{k: np.asarray(v) for k, v in entries.items()})


def load(path: str) -> Dict[str, np.ndarray]:
    """Every entry of the archive at `path`, in the order it was written."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def datasets(tree: Mapping[str, np.ndarray], group: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Datasets of `tree`: all of them under their full keys, or, with `group`,
    those directly in that group under their bare names."""
    out = {}
    for key, val in tree.items():
        if "@" in key:
            continue
        if group is None:
            out[key] = val
        elif key.startswith(group + "/"):
            out[key[len(group) + 1 :]] = val
    return out


def attrs(tree: Mapping[str, np.ndarray], key: str = "") -> Dict[str, np.ndarray]:
    """Attributes of the dataset `key` (of the file when `key` is empty)."""
    prefix = key + "@"
    return {k[len(prefix) :]: v for k, v in tree.items() if k.startswith(prefix)}
