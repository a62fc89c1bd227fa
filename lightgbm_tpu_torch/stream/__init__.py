"""Out-of-core streamed ingest, binning and training on one device.

The port of ``lightgbm_tpu/stream/`` (``data_stream_chunk_rows > 0``):

- ``source``: the ``ChunkSource`` contract and its in-memory, ``.npy``
  memory-map and delimited-text backends, yielding bounded float chunks;
- ``sampler``: round 1 samples the source for the bin mappers and the
  stored layout (the in-memory loader's code, so with
  ``bin_construct_sample_cnt >= N`` they are its own byte for byte),
  round 2 bins every chunk on the host into a ``StreamedDataset`` whose
  uint8 chunks are never concatenated;
- ``pipeline``: the chunks repacked to one row count, packed into int32
  words where ``tpu_bin_packing`` resolves to byte or nibble (streamed
  ``auto`` is byte), kept in pinned host memory and copied to the card
  on a side stream, ``prefetch`` chunks ahead, ordered by CUDA events;
- ``grow_stream``: frontier growth with the wave loop on the host, each
  wave one sweep over the chunks (route, then the smaller children's
  histogram partial, added in chunk order).

The user's entry stays ``Dataset`` and ``train``. A device mesh
(``ShardedSource`` over several processes, the sharded pipeline and
grower) is ROADMAP Queue 1 #13, and with it a sharded streamed resume; a
streamed booster checkpoints and resumes as an in-memory one does (its
fingerprint hashes the uint8 code chunks, ``checkpoint/snapshot.py``).
"""
from .source import ArraySource, ChunkSource, CsvSource, NpyMmapSource
from .sampler import StreamedDataset, ingest
from .pipeline import ChunkPipeline
from .grow_stream import StreamFrontierGrower

__all__ = [
    "ChunkSource", "ArraySource", "NpyMmapSource", "CsvSource",
    "StreamedDataset", "ingest", "ChunkPipeline", "StreamFrontierGrower",
]
