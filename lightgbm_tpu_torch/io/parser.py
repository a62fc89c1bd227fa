"""Text data parsing: CSV / TSV / LibSVM with format auto-detection.

The port's own copy of ``lightgbm_tpu/io/parser.py`` (the reference parser,
src/io/parser.cpp Parser::CreateParser, include/LightGBM/dataset.h:249-273):
host-side and NumPy-vectorized; the result feeds
``BinnedDataset.from_matrix``. The JAX package tries its C++ parser first
(``native.py``); that code stays bound to the JAX package, so this copy is
its Python path alone, which gives the same matrix.
"""
from __future__ import annotations

import io
import os
from typing import List, Optional, Tuple

import numpy as np

from ..log import LightGBMError, check


def _detect_format(sample_lines: List[str]) -> Tuple[str, str]:
    """Returns (kind, delimiter); kind in {csv, tsv, libsvm}.

    Mirrors Parser::CreateParser's heuristic: lines whose non-first tokens all
    look like ``idx:value`` are LibSVM; otherwise the delimiter yielding the
    most numeric columns wins (parser.cpp:100-160).
    """
    line = next((l for l in sample_lines if l.strip()), "")
    for delim, kind in (("\t", "tsv"), (",", "csv"), (" ", "space")):
        if delim in line:
            tokens = line.strip().split(delim)
            rest = tokens[1:] if len(tokens) > 1 else tokens
            if rest and all(":" in t for t in rest if t):
                return "libsvm", delim
            try:
                float(tokens[0])
                return ("csv" if kind == "csv" else "tsv" if kind == "tsv"
                        else "csv"), delim
            except ValueError:
                return ("csv" if kind == "csv" else "tsv" if kind == "tsv"
                        else "csv"), delim
    return "csv", ","


def _resolve_label_idx(label_column: str, header_names: Optional[List[str]]) -> int:
    if not label_column:
        return 0
    if label_column.startswith("name:"):
        name = label_column[5:]
        if header_names is None or name not in header_names:
            raise LightGBMError("Could not find label column %s in data file "
                                "or data file doesn't contain header" % name)
        return header_names.index(name)
    return int(label_column)


def parse_file(path: str, has_header: bool = False, label_column: str = "",
               max_lines: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Parse a data file into (features [N, F] float64, label [N], names).

    LibSVM feature indices are 0-based columns of the output matrix; the label
    is the configured column for delimited formats, the leading token for
    LibSVM.
    """
    check(os.path.exists(path), "Data file %s doesn't exist" % path)
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    if max_lines is not None:
        lines = lines[:max_lines]
    lines = [l for l in lines if l.strip()]
    if not lines:
        raise LightGBMError("Data file %s is empty" % path)

    header_names: Optional[List[str]] = None
    kind, delim = _detect_format(lines[:10] if not has_header else lines[1:11])
    if has_header:
        header_names = lines[0].strip().split(delim)
        lines = lines[1:]

    if kind == "libsvm":
        labels = np.empty(len(lines), dtype=np.float64)
        rows: List[List[Tuple[int, float]]] = []
        max_idx = -1
        for i, line in enumerate(lines):
            tokens = line.strip().split(delim)
            labels[i] = float(tokens[0])
            row = []
            for t in tokens[1:]:
                if not t:
                    continue
                k, v = t.split(":", 1)
                k = int(k)
                row.append((k, float(v)))
                max_idx = max(max_idx, k)
            rows.append(row)
        X = np.zeros((len(lines), max_idx + 1), dtype=np.float64)
        for i, row in enumerate(rows):
            for k, v in row:
                X[i, k] = v
        return X, labels, header_names

    # delimited
    label_idx = _resolve_label_idx(label_column, header_names)
    X, labels = _parse_delimited_block(lines, delim, label_idx)
    if header_names is not None:
        header_names = [h for i, h in enumerate(header_names) if i != label_idx]
    return X, labels, header_names


def load_query_file(data_path: str) -> Optional[np.ndarray]:
    """Load ``<data>.query`` group sizes if present (metadata.cpp query file)."""
    qpath = data_path + ".query"
    if not os.path.exists(qpath):
        return None
    return np.loadtxt(qpath, dtype=np.int64).reshape(-1)


def load_weight_file(data_path: str) -> Optional[np.ndarray]:
    """Load ``<data>.weight`` per-row weights if present (metadata.cpp)."""
    wpath = data_path + ".weight"
    if not os.path.exists(wpath):
        return None
    return np.loadtxt(wpath, dtype=np.float64).reshape(-1)


def load_init_score_file(data_path: str) -> Optional[np.ndarray]:
    wpath = data_path + ".init"
    if not os.path.exists(wpath):
        return None
    return np.loadtxt(wpath, dtype=np.float64).reshape(-1)


def sniff_libsvm(path: str) -> bool:
    """True when the file looks like LibSVM (sparse k:v tokens) — the
    two_round chunked loader needs a global feature count, so such files
    take the one-shot parser instead."""
    if not os.path.exists(path):
        return False
    head = []
    with open(path, "r") as fh:
        for line in fh:
            if line.strip():
                head.append(line.rstrip("\n"))
            if len(head) >= 10:
                break
    if not head:
        return False
    kind, _ = _detect_format(head)
    return kind == "libsvm"


def _parse_delimited_block(lines: List[str], delim: str, label_idx: int):
    """genfromtxt a block of delimited lines -> (X, labels). Shared by the
    one-shot and chunked loaders so format fixes apply to both."""
    data = np.genfromtxt(io.StringIO("\n".join(lines)), delimiter=delim,
                         dtype=np.float64)
    if data.ndim == 1:
        data = data.reshape(len(lines), -1)
    labels = data[:, label_idx].copy()
    X = np.delete(data, label_idx, axis=1)
    return X, labels


def parse_file_chunks(path: str, has_header: bool = False,
                      label_column: str = "", chunk_rows: int = 262144):
    """Stream a delimited data file as (X [c, F] float64, label [c]) chunks.

    The two-round loading front end (dataset_loader.cpp:160-219's
    >memory-file path): nothing larger than one chunk of float64 is ever
    materialized. LibSVM needs a global feature count up front, so sparse
    files take the one-shot parser instead.
    """
    check(os.path.exists(path), "Data file %s doesn't exist" % path)
    with open(path, "r") as fh:
        head = []
        for line in fh:
            if line.strip():
                head.append(line)
            if len(head) >= 11:
                break
    if not head:
        raise LightGBMError("Data file %s is empty" % path)
    kind, delim = _detect_format([l.rstrip("\n") for l in
                                  (head[1:] if has_header else head)])
    if kind == "libsvm":
        raise LightGBMError(
            "two_round loading supports delimited files only; "
            "LibSVM input needs the one-shot parser")
    header_names: Optional[List[str]] = None
    with open(path, "r") as fh:
        if has_header:
            header_names = fh.readline().strip().split(delim)
        label_idx = _resolve_label_idx(label_column, header_names)
        names = None
        if header_names is not None:
            names = [h for i, h in enumerate(header_names)
                     if i != label_idx]
        buf: List[str] = []

        def flush():
            return _parse_delimited_block(buf, delim, label_idx)

        for line in fh:
            if not line.strip():
                continue
            buf.append(line.rstrip("\n"))
            if len(buf) >= chunk_rows:
                yield flush() + (names,)
                buf = []
        if buf:
            yield flush() + (names,)
