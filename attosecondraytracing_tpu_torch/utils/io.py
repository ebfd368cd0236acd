"""Results persistence: lzma-compressed pickles with auto-numbered filenames
(ART/ModuleProcessing.py:612-633 semantics)."""

from __future__ import annotations

import lzma
import os
import pickle
from datetime import datetime


def save_compressed(obj, filename: str | None = None) -> str:
    """Pickle ``obj`` to ``<filename>_<i>.xz`` (first free index i)."""
    if not isinstance(filename, str):
        filename = "kept_data_" + datetime.now().strftime("%Y-%m-%d-%Hh%M")
    i = 0
    while os.path.exists(filename + f"_{i}.xz"):
        i += 1
    filename = filename + f"_{i}"
    with lzma.open(filename + ".xz", "wb") as f:
        pickle.dump(obj, f)
    print("Saved results to " + filename + ".xz.")
    print("->To reload from disk do: kept_data = load_compressed('" + filename + "')")
    return filename


def load_compressed(filename: str):
    """Load an object saved by :func:`save_compressed`."""
    with lzma.open(filename + ".xz", "rb") as f:
        return pickle.load(f)
