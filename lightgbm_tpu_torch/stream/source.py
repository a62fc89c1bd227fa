"""Chunked raw-data sources for out-of-core ingest.

The port of ``lightgbm_tpu/stream/source.py``. A ``ChunkSource`` is the
streamed counterpart of the raw [N, F] matrix every in-memory path starts
from: a restartable iterator of bounded float chunks. ``reset()`` rewinds
it, so the two-round loader (``stream/sampler.py``) can pass over the data
twice, once to sample the bin boundaries and once to bin every chunk, the
contract the reference's ``DatasetLoader`` has with its text parsers
(dataset_loader.cpp:160-219).

Backends:

- ``ArraySource``: an in-memory dense matrix, sliced by rows (the case every
  streamed-against-single-shot comparison runs from);
- ``NpyMmapSource``: a ``.npy`` file opened with ``mmap_mode="r"``: each
  chunk copies one row slice out of the page cache, so the float rows in
  memory are one chunk whatever the file's size;
- ``CsvSource``: delimited text through ``io/parser.parse_file_chunks``
  (LibSVM is refused: a sparse file has no feature count until it has been
  read to the end).

Every backend checks what it is given (shape, float dtype, label length)
when it is built or on its first chunk, and raises a ``LightGBMError``
naming the problem. ``ShardedSource`` (one process's rows of a device
mesh) takes one process only: several are ROADMAP Queue 1 #13 slice b.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..log import LightGBMError, check, outside_slice

# one yielded chunk: (X [c, F] float64, label [c] float64 | None)
Chunk = Tuple[np.ndarray, Optional[np.ndarray]]


class ChunkSource:
    """Restartable iterator of (X_chunk, label_chunk) pairs.

    Contract: ``reset()`` rewinds to the first chunk; ``__iter__`` then
    yields every chunk once, in a FIXED order (chunk order is part of
    the streamed dataset's identity — the checkpoint fingerprint hashes
    chunks in order). ``chunk_rows`` bounds every chunk's row count;
    ``feature_names`` may be None until the first chunk has been read.
    """

    chunk_rows: int = 0
    feature_names: Optional[List[str]] = None

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Chunk]:
        raise NotImplementedError


def _check_chunk_rows(chunk_rows: int) -> int:
    chunk_rows = int(chunk_rows)
    check(chunk_rows > 0,
          "stream chunk_rows should be > 0, got %d" % chunk_rows)
    return chunk_rows


class ArraySource(ChunkSource):
    """In-memory dense matrix sliced into row chunks."""

    def __init__(self, data, label=None, chunk_rows: int = 262144):
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        if hasattr(data, "tocsr") or hasattr(data, "tocsc"):
            raise LightGBMError(
                "streamed ingest does not support sparse input; "
                "densify or set data_stream_chunk_rows=0")
        data = np.asarray(data)
        if data.ndim != 2:
            raise LightGBMError(
                "streamed ingest needs 2-D data, got shape %s"
                % (data.shape,))
        try:
            self._X = np.asarray(data, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise LightGBMError(
                "streamed ingest could not coerce data to float: %s" % e)
        self._y = None
        if label is not None:
            self._y = np.asarray(label, dtype=np.float64).reshape(-1)
            if len(self._y) != self._X.shape[0]:
                raise LightGBMError(
                    "label length %d does not match %d data rows"
                    % (len(self._y), self._X.shape[0]))
        self.num_rows = int(self._X.shape[0])

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[Chunk]:
        n = self._X.shape[0]
        for start in range(0, n, self.chunk_rows):
            stop = min(start + self.chunk_rows, n)
            yield (self._X[start:stop],
                   self._y[start:stop] if self._y is not None else None)


class NpyMmapSource(ChunkSource):
    """Row chunks out of a memory-mapped ``.npy`` matrix.

    ``np.load(mmap_mode="r")`` keeps the file on disk; each yielded chunk
    copies one row-slice (so downstream code may hold it without pinning
    the map). ``label`` is either an in-memory array or a path to a 1-D
    ``.npy`` of matching length.
    """

    def __init__(self, path: str, label=None, chunk_rows: int = 262144):
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        check(os.path.exists(path), "Data file %s doesn't exist" % path)
        self.path = path
        try:
            mm = np.load(path, mmap_mode="r")
        except Exception as e:  # noqa: BLE001 - surface as config error
            raise LightGBMError("could not mmap %s as .npy: %s" % (path, e))
        if mm.ndim != 2:
            raise LightGBMError(
                "%s should hold a 2-D matrix, got shape %s"
                % (path, mm.shape))
        self._shape = mm.shape
        self.num_rows = int(mm.shape[0])
        del mm
        self._y: Optional[np.ndarray] = None
        if isinstance(label, str):
            check(os.path.exists(label),
                  "Label file %s doesn't exist" % label)
            self._y = np.asarray(np.load(label), np.float64).reshape(-1)
        elif label is not None:
            self._y = np.asarray(label, np.float64).reshape(-1)
        if self._y is not None and len(self._y) != self._shape[0]:
            raise LightGBMError(
                "label length %d does not match %d rows of %s"
                % (len(self._y), self._shape[0], path))

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[Chunk]:
        mm = np.load(self.path, mmap_mode="r")
        try:
            n = mm.shape[0]
            for start in range(0, n, self.chunk_rows):
                stop = min(start + self.chunk_rows, n)
                X = np.array(mm[start:stop], dtype=np.float64)
                y = self._y[start:stop] if self._y is not None else None
                yield X, y
        finally:
            del mm


def shard_offsets(total_rows: int, world: int) -> List[int]:
    """The canonical shard-assignment contract: ``world`` CONTIGUOUS
    rank-ordered row blocks, shard ``p`` owning rows
    ``[off[p], off[p+1])`` with ``off[p] = floor(p * N / world)``.
    Concatenating the shards in rank order reproduces the original row
    order — which is what makes the allgathered bin-boundary sample and
    the rank-folded checkpoint fingerprint well defined (the same
    contract as the reference's distributed row partition,
    dataset_loader.cpp:469-495, minus the dropped remainder rows)."""
    check(world >= 1, "shard world should be >= 1, got %d" % world)
    check(total_rows >= world,
          "cannot shard %d rows over %d processes (every shard needs at "
          "least one row)" % (total_rows, world))
    return [total_rows * p // world for p in range(world + 1)]


class ShardedSource(ChunkSource):
    """One rank's contiguous row block of an inner ``ChunkSource``; the port
    takes world 1 only (the whole source), a mesh being ROADMAP Queue 1
    #13 slice b.

    Wraps any restartable source and yields only the rows in
    ``[offsets[rank], offsets[rank+1])``, re-chunked to the inner
    source's ``chunk_rows`` bound. The inner source is still streamed in
    full (chunk row counts are only known by reading), but rows outside
    the shard are dropped immediately, so peak memory stays one chunk.

    ``total_rows`` must be known up front (``ArraySource`` /
    ``NpyMmapSource`` know theirs; text sources need it passed
    explicitly) unless explicit ``offsets`` are given — the hook the
    skewed-shard tests use.
    """

    def __init__(self, inner: ChunkSource, rank: int, world: int,
                 total_rows: Optional[int] = None,
                 offsets: Optional[List[int]] = None):
        if int(world) > 1:
            raise outside_slice("sharded streamed ingest over %d processes "
                                "(ShardedSource)" % int(world),
                                "ROADMAP Queue 1 #13 slice b")
        self.inner = inner
        self.chunk_rows = inner.chunk_rows
        self.shard_rank = int(rank)
        self.shard_world = int(world)
        check(0 <= self.shard_rank < self.shard_world,
              "shard rank %d out of range for world %d"
              % (self.shard_rank, self.shard_world))
        if offsets is not None:
            offs = [int(o) for o in offsets]
            check(len(offs) == self.shard_world + 1,
                  "explicit shard offsets need world+1=%d entries, got %d"
                  % (self.shard_world + 1, len(offs)))
            check(offs[0] == 0 and
                  all(offs[i] < offs[i + 1] for i in range(len(offs) - 1)),
                  "shard offsets must start at 0 and strictly increase "
                  "(every shard needs at least one row), got %s" % (offs,))
        else:
            if total_rows is None:
                total_rows = getattr(inner, "num_rows", None)
            check(total_rows is not None,
                  "ShardedSource needs total_rows (or explicit offsets) "
                  "for a source that cannot report its row count up front")
            offs = shard_offsets(int(total_rows), self.shard_world)
        self.offsets = offs
        self.total_rows = offs[-1]

    @property
    def feature_names(self):  # inner may learn names on first read
        return self.inner.feature_names

    @feature_names.setter
    def feature_names(self, v):
        self.inner.feature_names = v

    def reset(self) -> None:
        self.inner.reset()

    def __iter__(self) -> Iterator[Chunk]:
        lo = self.offsets[self.shard_rank]
        hi = self.offsets[self.shard_rank + 1]
        pos = 0
        for Xc, yc in self.inner:
            n = Xc.shape[0]
            a = max(lo - pos, 0)
            b = min(hi - pos, n)
            if a < b:
                yield (Xc[a:b],
                       yc[a:b] if yc is not None else None)
            pos += n
            if pos >= hi:
                break
        check(pos >= hi,
              "sharded source exhausted at row %d before reaching shard "
              "end %d — total_rows/offsets overstate the inner source"
              % (pos, hi))


class CsvSource(ChunkSource):
    """Delimited text file streamed through ``parser.parse_file_chunks``."""

    def __init__(self, path: str, chunk_rows: int = 262144,
                 has_header: bool = False, label_column: str = ""):
        from ..io import parser as parser_mod
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        check(os.path.exists(path), "Data file %s doesn't exist" % path)
        if parser_mod.sniff_libsvm(path):
            raise LightGBMError(
                "streamed ingest supports delimited files only; LibSVM "
                "input needs the one-shot parser "
                "(data_stream_chunk_rows=0)")
        self.path = path
        self.has_header = bool(has_header)
        self.label_column = str(label_column)

    def reset(self) -> None:
        pass

    def __iter__(self) -> Iterator[Chunk]:
        from ..io.parser import parse_file_chunks
        for Xc, yc, names in parse_file_chunks(
                self.path, has_header=self.has_header,
                label_column=self.label_column,
                chunk_rows=self.chunk_rows):
            if self.feature_names is None and names:
                self.feature_names = list(names)
            yield np.asarray(Xc, np.float64), np.asarray(yc, np.float64)
