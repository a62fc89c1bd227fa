"""Chunk transfer from pinned host memory to the card, ahead of its use.

The port of ``lightgbm_tpu/stream/pipeline.py``. The JAX package overlaps
its transfers with asynchronous ``jax.device_put`` calls; here the uniform
host chunks live in pinned memory and a side CUDA stream copies them into
a ring of ``prefetch`` device buffers while the current stream sweeps the
chunk before them. Events order the two streams both ways:

- the sweep of chunk i waits (on the device) for its copy's event;
- the copy of chunk i + prefetch into the same buffer waits for an event
  recorded on the current stream after the last kernel that reads chunk i,
  so a copy never overwrites a buffer that is still being read.

Nothing here blocks the host. ``stats()`` keeps the JAX package's
accounting, measured on the device with CUDA events: ``wait_s`` is the time
the current stream waited for copies, ``total_s`` the device time from a
sweep's first chunk to its last chunk's work, so ``overlap_efficiency = 1 -
wait_s / total_s`` is 1 when every copy ended under the sweep of the chunk
before it, and ``ingest_rows_per_sec`` the rows swept a second. On the
CPU (the tests) the chunks are the host tensors themselves, ``wait_s`` is 0
and ``total_s`` the host clock.

Chunks are repacked on the host to one row count ``chunk_rows`` (the last
padded with zero rows), so every buffer has one shape. Row r of uniform
chunk i is row i * R + r; rows past ``num_data`` are masked off by the
grower (mask 0). With ``packed`` the host chunks are int32 words, four
codes each (``core/binpack.py``), the kernels' word layout; ``num_cols``
stays the stored column count C. ``ShardedChunkPipeline`` (a mesh) is
ROADMAP Queue 1 #13.
"""
from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.binpack import pack_words_np
from ..log import check


def repack_uniform(chunks: List[np.ndarray], chunk_rows: int
                   ) -> Tuple[List[np.ndarray], int]:
    """Ragged uint8 chunks -> (chunks of exactly ``chunk_rows`` rows, the
    last zero-padded, and the row count), chunk by chunk: the full matrix
    is never concatenated."""
    check(chunk_rows > 0, "chunk_rows should be > 0, got %d" % chunk_rows)
    ncols = chunks[0].shape[1] if chunks else 0
    out: List[np.ndarray] = []
    buf = np.zeros((chunk_rows, ncols), np.uint8)
    fill = 0
    total = 0
    for c in chunks:
        c = np.asarray(c, np.uint8)
        total += c.shape[0]
        pos = 0
        while pos < c.shape[0]:
            take = min(chunk_rows - fill, c.shape[0] - pos)
            buf[fill:fill + take] = c[pos:pos + take]
            fill += take
            pos += take
            if fill == chunk_rows:
                out.append(buf)
                buf = np.zeros((chunk_rows, ncols), np.uint8)
                fill = 0
    if fill > 0:
        out.append(buf)          # trailing rows stay zero-padded
    return out, total


def _timing_event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


class ChunkPipeline:
    """Sweeps over uniform bin chunks on ``device``, ``prefetch`` copies
    ahead of their use."""

    def __init__(self, chunks: List[np.ndarray], chunk_rows: int,
                 prefetch: int = 2, device=None, packed: bool = False):
        self.chunk_rows = int(chunk_rows)
        self.prefetch = max(1, int(prefetch))
        self.device = torch.device(device if device is not None else "cpu")
        host, self.num_data = repack_uniform(chunks, self.chunk_rows)
        self.num_chunks = len(host)
        self.num_cols = host[0].shape[1] if host else 0
        self.packed = bool(packed)
        if self.packed:
            host = [pack_words_np(c) for c in host]
        cuda = self.device.type == "cuda"
        self.host_chunks = [torch.from_numpy(c).pin_memory() if cuda
                            else torch.from_numpy(c) for c in host]
        self.num_padded = self.num_chunks * self.chunk_rows
        # valid (unpadded) rows of each uniform chunk
        self.valid_rows = [
            min(self.chunk_rows, self.num_data - i * self.chunk_rows)
            for i in range(self.num_chunks)]
        # accounting, over every sweep
        self.sweeps = 0
        self.rows_transferred = 0
        self.wait_s = 0.0
        self.total_s = 0.0
        self._timings: list = []    # (start, end, [(before, after)]) events
        if cuda and self.num_chunks:
            slots = min(self.prefetch, self.num_chunks)
            self._copy_stream = torch.cuda.Stream(self.device)
            self._buffers = [torch.empty_like(self.host_chunks[0],
                                              device=self.device)
                             for _ in range(slots)]
            # a buffer's copy has landed / its last reader has run
            self._copied = [torch.cuda.Event() for _ in range(slots)]
            self._released = [torch.cuda.Event() for _ in range(slots)]

    @property
    def rows_per_sweep(self) -> int:
        return self.num_data

    def _put(self, i: int) -> None:
        """Copy chunk i into its ring buffer on the side stream, once the
        buffer's last reader has run."""
        slot = i % len(self._buffers)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._released[slot])
            self._buffers[slot].copy_(self.host_chunks[i], non_blocking=True)
            self._copied[slot].record(self._copy_stream)

    def sweep(self) -> Iterator[Tuple[int, torch.Tensor]]:
        """Yield (chunk index, chunk on the device) once a chunk, in order.
        The consumer enqueues its work on a chunk before it advances; the
        buffer is reused ``prefetch`` chunks later, after that work."""
        self.sweeps += 1
        self.rows_transferred += self.rows_per_sweep
        if self.device.type != "cuda" or not self.num_chunks:
            t0 = time.perf_counter()
            yield from enumerate(self.host_chunks)
            self.total_s += time.perf_counter() - t0
            return
        self._resolve_timings()
        cur = torch.cuda.current_stream(self.device)
        start, waits = _timing_event(), []
        start.record(cur)
        slots = len(self._buffers)
        for i in range(slots):
            self._put(i)
        for i in range(self.num_chunks):
            slot = i % slots
            before, after = _timing_event(), _timing_event()
            before.record(cur)
            cur.wait_event(self._copied[slot])
            after.record(cur)
            waits.append((before, after))
            yield i, self._buffers[slot]
            self._released[slot].record(cur)
            if i + slots < self.num_chunks:
                self._put(i + slots)
        end = _timing_event()
        end.record(cur)
        self._timings.append((start, end, waits))

    def _resolve_timings(self) -> None:
        """Fold the finished sweeps' events into ``total_s`` and
        ``wait_s`` (each waits for its sweep's last event, which has
        already run when the grower read its wave's count)."""
        for start, end, waits in self._timings:
            end.synchronize()
            self.total_s += start.elapsed_time(end) / 1000.0
            self.wait_s += sum(b.elapsed_time(a) for b, a in waits) / 1000.0
        self._timings = []

    # ------------------------------------------------------------- stats
    def overlap_efficiency(self) -> float:
        self._resolve_timings()
        return 1.0 - self.wait_s / self.total_s if self.total_s > 0 else 1.0

    def ingest_rows_per_sec(self) -> Optional[float]:
        self._resolve_timings()
        return self.rows_transferred / self.total_s if self.total_s > 0 \
            else None

    def stats(self) -> dict:
        self._resolve_timings()
        return {
            "num_chunks": self.num_chunks,
            "chunk_rows": self.chunk_rows,
            "prefetch": self.prefetch,
            "sweeps": self.sweeps,
            "rows_transferred": self.rows_transferred,
            "wait_s": self.wait_s,
            "total_s": self.total_s,
            "overlap_efficiency": self.overlap_efficiency(),
            "ingest_rows_per_sec": self.ingest_rows_per_sec(),
        }
