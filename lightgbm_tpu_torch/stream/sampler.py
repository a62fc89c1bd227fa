"""Two-round sample-based binning over a ``ChunkSource``.

The port of ``lightgbm_tpu/stream/sampler.py``. Round 1 streams the source
once and samples up to ``bin_construct_sample_cnt`` rows; the bin mappers
and the stored layout (EFB bundles, packed pairs) come from that sample
through ``BinnedDataset.from_matrix``, the code every in-memory dataset
runs, so the boundaries are ``from_file_two_round``'s bit for bit (the same
random stream and Algorithm R: the fill phase keeps the rows in order, so
the sample is the data whenever ``bin_construct_sample_cnt >= N``). Round 2
streams again and bins each chunk on the host against that layout
(``from_matrix(reference=...)``), keeping the uint8 chunks apart: a
``StreamedDataset`` never concatenates them, so the host holds the binned
chunks (~N * C bytes) and one float chunk, and the card what
``pipeline.ChunkPipeline`` copies there.

Sharded ingest over several processes (``comm``, a ``ShardedSource`` of
world > 1) is ROADMAP Queue 1 #13.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..io.dataset import BinnedDataset, Metadata
from ..log import Log, LightGBMError, outside_slice
from .source import ChunkSource


class StreamedDataset(BinnedDataset):
    """A ``BinnedDataset`` whose bin matrix lives as host chunks.

    The layout (mappers, EFB columns, packed pairs) is the in-memory
    class's; ``X_binned`` stays None and ``chunks`` holds the ordered uint8
    [c_i, C] pieces (the c_i add up to ``num_data``). What needs the matrix
    in one piece refuses instead of concatenating it: ``save_binary`` here,
    rollback and replays of the training rows in the booster."""

    is_streamed = True

    def __init__(self):
        super().__init__()
        self.chunks: List[np.ndarray] = []

    @property
    def chunk_row_counts(self) -> List[int]:
        return [int(c.shape[0]) for c in self.chunks]

    def data_profile(self):
        """The bin-occupancy profile accumulated chunk by chunk, the
        in-memory profile's counts exactly (sampler.py:65-71 of the JAX
        package)."""
        if self._data_profile is None:
            from ..obs.drift import DataProfile
            self._data_profile = DataProfile.from_binned_chunks(self)
        return self._data_profile

    def save_binary(self, path: str) -> None:
        raise LightGBMError(
            "save_binary is not supported for streamed datasets "
            "(data_stream_chunk_rows > 0): the bin matrix is never "
            "materialized in one piece. Save the raw source instead.")


def _systematic_sample(stride: int):
    """Every ``stride``-th row, across chunks (``sample_stride`` > 0): a
    deterministic alternative to the reservoir."""
    state = {"next": 0, "seen": 0}

    def pick(c: int) -> np.ndarray:
        lo = state["next"] - state["seen"]
        idx = np.arange(max(lo, 0), c, stride, dtype=np.int64) \
            if lo < c else np.empty(0, np.int64)
        if len(idx):
            state["next"] = state["seen"] + int(idx[-1]) + stride
        state["seen"] += c
        return idx

    return pick


def ingest(source: ChunkSource, config,
           feature_names: Optional[List[str]] = None,
           categorical_feature=None,
           sample_stride: int = 0,
           comm=None) -> StreamedDataset:
    """A ``StreamedDataset`` from a chunk source, in two passes.

    ``sample_stride > 0`` samples every k-th row in round 1 instead of the
    reservoir (at most ``bin_construct_sample_cnt`` rows, the earliest
    kept). ``comm`` (sharded ingest across processes) refuses: ROADMAP
    Queue 1 #13."""
    if comm is not None or int(getattr(source, "shard_world", 1) or 1) > 1:
        raise outside_slice("sharded streamed ingest (comm, ShardedSource)",
                            "ROADMAP Queue 1 #13")
    sample_cnt = int(config.bin_construct_sample_cnt)
    rng = np.random.RandomState(config.data_random_seed)
    picker = _systematic_sample(int(sample_stride)) if sample_stride > 0 \
        else None

    source.reset()
    sample_rows: list = []
    labels: list = []
    n_total = 0
    n_features = -1
    n_chunks = 0
    for xc, yc in source:
        xc = np.asarray(xc, np.float64)
        if xc.ndim != 2:
            raise LightGBMError(
                "chunk %d is not 2-D (shape %s)" % (n_chunks, (xc.shape,)))
        if n_features < 0:
            n_features = xc.shape[1]
        elif xc.shape[1] != n_features:
            raise LightGBMError(
                "chunk %d has %d features, expected %d — every chunk of a "
                "streamed source must share one feature space"
                % (n_chunks, xc.shape[1], n_features))
        if yc is not None:
            labels.append(np.asarray(yc, np.float64).reshape(-1))
        elif labels:
            raise LightGBMError(
                "chunk %d has no label but earlier chunks did" % n_chunks)
        c = xc.shape[0]
        if picker is not None:
            for i in picker(c):
                if len(sample_rows) < sample_cnt:
                    sample_rows.append(xc[i].copy())
        else:
            # Algorithm R as from_file_two_round runs it: fill in order,
            # then row i draws j ~ U[0, n_total + i] and takes slot j when
            # j < sample_cnt
            fill = max(0, min(sample_cnt - n_total, c))
            for i in range(fill):
                sample_rows.append(xc[i].copy())
            if fill < c:
                draws = (rng.random_sample(c - fill)
                         * (n_total + np.arange(fill, c) + 1)
                         ).astype(np.int64)
                for i in np.nonzero(draws < sample_cnt)[0]:
                    sample_rows[draws[i]] = xc[fill + i].copy()
        n_total += c
        n_chunks += 1
    if n_total == 0:
        raise LightGBMError("streamed source yielded no rows")

    names = feature_names or source.feature_names
    proto = BinnedDataset.from_matrix(
        np.asarray(sample_rows), config,
        feature_names=names, categorical_feature=categorical_feature)

    source.reset()
    chunks: List[np.ndarray] = []
    row = 0
    for xc, _yc in source:
        bc = BinnedDataset.from_matrix(
            np.asarray(xc, np.float64), config, reference=proto)
        chunks.append(np.ascontiguousarray(bc.X_binned))
        row += xc.shape[0]
    if row != n_total:
        raise LightGBMError(
            "source is not restartable: round 2 yielded %d rows, round 1 "
            "saw %d — reset() must rewind to the identical chunk stream"
            % (row, n_total))

    sd = StreamedDataset()
    sd.__dict__.update(proto.__dict__)
    sd.X_binned = None
    sd.chunks = chunks
    sd.num_data = n_total
    sd.metadata = Metadata(n_total)
    if labels:
        sd.metadata.set_label(np.concatenate(labels))
    Log.info("stream: ingested %d rows in %d chunks (%d stored columns, "
             "sample=%d rows)", n_total, len(chunks),
             chunks[0].shape[1] if chunks else 0, len(sample_rows))
    return sd
