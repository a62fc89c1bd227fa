"""Rank groups: the collectives the distributed learners run over.

The port of ``lightgbm_tpu/parallel/network.py`` (``init``, ``free``,
``num_machines``, ``rank``, :27-98; ``check_model_agreement``,
:277-310; ``LoopbackComm``, :330-380). Where the JAX package compiles its
collectives into the training step over a device mesh, the port's growers
call one small interface, a group endpoint of one rank:

- ``rank``, ``world``, ``device``;
- ``all_reduce_sum_(t)``: every rank's ``t`` replaced, in place, by the
  sum over the ranks;
- ``reduce_scatter_sum(t, dim)``: the sum over the ranks of this rank's
  block of ``t`` along ``dim`` (the size divides by ``world``; rank r's
  block is the r-th contiguous one);
- ``all_gather(t)``: ``[world, *t.shape]``, the ranks' tensors in rank
  order;
- ``all_gather_object(obj)``: the ranks' objects in rank order.

Two implementations stand behind it:

- ``ThreadGroup``: ``world`` ranks as threads of one process (the
  counterpart of a one-process mesh, ``mesh_shape=[P]``, and of the JAX
  package's ``LoopbackComm``). Its sums add the ranks' tensors in rank
  order on every rank, so every rank receives the same bytes.
- ``DistGroup``: ``torch.distributed`` across processes
  (``num_machines > 1``; ``init`` and ``Booster.set_network``). The
  backend is NCCL where every rank has a card of its own, gloo otherwise
  (the CPU, or several ranks on one card). Two rules of the transport are
  explicit, logged once and counted in ``PayloadCounter.staged`` and
  ``.emulated_rs``: under gloo a CUDA tensor crosses through pinned host
  memory, and a reduce-scatter is an all-reduce and a slice.

Every endpoint keeps a ``PayloadCounter``: the floating-point elements
that it receives per collective under the JAX package's rules
(``lightgbm_tpu/obs/perfgate.py:113-121``: an all-reduce receives its
operand, a reduce-scatter the operand over P, an all-gather P times the
operand; integer traffic counts as a collective and no payload), beside
it what the transport really received (``moved``: the whole operand of a
reduce-scatter that gloo runs as an all-reduce), the seconds it spends in
them, and, per frontier wave, both tallies of that wave.
``ExternalComm`` and ``init_with_functions`` belong to the C API, which
the port does not port.
"""
from __future__ import annotations

import os
import threading
import time
from datetime import timedelta
from typing import List, Optional

import torch

from ..log import LightGBMError, Log


class PayloadCounter:
    """What one rank's collectives moved: counts and received floating
    elements by collective, seconds inside them, and one payload a
    frontier wave (``wave_mark`` opens a wave's tally). ``payload`` and
    ``waves`` follow the JAX package's rules; ``moved`` and
    ``waves_moved`` count what the transport really received, which
    differs where gloo runs a reduce-scatter as an all-reduce (the whole
    operand, not its share)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = {}          # collective -> calls
        self.payload = {}        # collective -> floating elements received
        self.moved = {}          # collective -> what the transport received
        self.op_seconds = {}     # collective -> seconds inside it
        self.seconds = 0.0
        self.waves: List[float] = []
        self.waves_moved: List[float] = []
        self.wave_splits: List[int] = []
        self.staged = 0          # gloo: CUDA tensors through host memory
        self.emulated_rs = 0     # gloo: reduce-scatters as all-reduces
        self._wave_start = None

    def add(self, op: str, t: torch.Tensor, received: float,
            seconds: float, moved: Optional[float] = None) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        if t.is_floating_point():
            self.payload[op] = self.payload.get(op, 0.0) + float(received)
            self.moved[op] = self.moved.get(op, 0.0) + float(
                received if moved is None else moved)
        self.op_seconds[op] = self.op_seconds.get(op, 0.0) + seconds
        self.seconds += seconds

    def total(self) -> float:
        return float(sum(self.payload.values()))

    def _totals(self):
        return self.total(), float(sum(self.moved.values()))

    def wave_mark(self, splits: int = 0) -> None:
        """Close the open wave's tally, if any, and open the next, of
        ``splits`` splits."""
        self.wave_end()
        self._wave_start = self._totals()
        self.wave_splits.append(int(splits))

    def wave_end(self) -> None:
        if self._wave_start is not None:
            (p0, m0), (p1, m1) = self._wave_start, self._totals()
            self.waves.append(p1 - p0)
            self.waves_moved.append(m1 - m0)
        self._wave_start = None

    def summary(self) -> dict:
        return {"calls": dict(self.calls), "payload": dict(self.payload),
                "moved": dict(self.moved),
                "seconds": self.seconds, "op_seconds": dict(self.op_seconds),
                "waves": list(self.waves),
                "waves_moved": list(self.waves_moved),
                "wave_splits": list(self.wave_splits),
                "staged": self.staged, "emulated_rs": self.emulated_rs}


class _Timed:
    """Times one collective into the counter."""

    def __init__(self, counter: PayloadCounter, op: str, t: torch.Tensor,
                 received: float, moved: Optional[float] = None):
        self.counter, self.op, self.t, self.received = (counter, op, t,
                                                        received)
        self.moved = moved

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.counter.add(self.op, self.t, self.received,
                             time.perf_counter() - self.t0, self.moved)


class ThreadGroup:
    """One rank of ``world`` thread ranks in one process, with
    barrier-synchronised collectives (``LoopbackComm``'s semantics: rank
    ordered, in lockstep). A rank that dies between two waits breaks the
    barrier (``abort``), so its peers raise instead of waiting for ever;
    ``timeout_s`` bounds every wait."""

    def __init__(self, shared: dict, rank: int, device: torch.device):
        self._shared = shared
        self.rank = rank
        self.world = len(shared["slots"])
        self.device = device
        self.counter = PayloadCounter()

    @staticmethod
    def group(world: int, devices=None,
              timeout_s: Optional[float] = None) -> List["ThreadGroup"]:
        """``world`` endpoints, rank r on ``devices[r]`` (the CPU by
        default). Ranks on CUDA need a card each."""
        devices = ([torch.device("cpu")] * world if devices is None
                   else [torch.device(d) for d in devices])
        cuda = [d for d in devices if d.type == "cuda"]
        if len({(d.index or 0) for d in cuda}) < len(cuda):
            raise LightGBMError(
                "thread ranks on CUDA need a card each: %d ranks on %s"
                % (world, sorted({str(d) for d in cuda})))
        shared = {"slots": [None] * world,
                  "barrier": threading.Barrier(world),
                  "timeout_s": timeout_s, "aborted_by": None}
        return [ThreadGroup(shared, r, devices[r]) for r in range(world)]

    def abort(self) -> None:
        if self._shared.get("aborted_by") is None:
            self._shared["aborted_by"] = self.rank
        self._shared["barrier"].abort()

    def _wait(self, phase: str) -> None:
        try:
            self._shared["barrier"].wait(self._shared.get("timeout_s"))
        except threading.BrokenBarrierError:
            culprit = self._shared.get("aborted_by")
            raise LightGBMError(
                "thread group collective aborted at %s on rank %d%s"
                % (phase, self.rank,
                   ": rank %d failed" % culprit if culprit is not None
                   else " (barrier broken or timed out)")) from None

    def _exchange(self, obj):
        """Every rank's ``obj`` in rank order; the caller must read the
        list before ``_drain``."""
        try:
            self._shared["slots"][self.rank] = obj
            self._wait("publish")
            return list(self._shared["slots"])
        except LightGBMError:
            raise
        except BaseException:
            self.abort()
            raise

    def _drain(self) -> None:
        self._wait("drain")

    def _sum(self, parts: List[torch.Tensor]) -> torch.Tensor:
        out = parts[0].to(self.device, copy=True)
        for p in parts[1:]:
            out += p.to(self.device)
        return out

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        with _Timed(self.counter, "all_reduce", t, t.numel()):
            out = self._sum(self._exchange(t))
            self._drain()
            t.copy_(out)
        return t

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        size = t.shape[dim]
        check_divides(size, self.world, "reduce_scatter")
        blk = size // self.world
        with _Timed(self.counter, "reduce_scatter", t,
                    t.numel() / self.world):
            parts = self._exchange(t)
            out = self._sum([p.narrow(dim, self.rank * blk, blk)
                             for p in parts])
            self._drain()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        with _Timed(self.counter, "all_gather", t, t.numel() * self.world):
            out = torch.stack([p.to(self.device) for p in
                               self._exchange(t)])
            self._drain()
        return out

    def all_gather_object(self, obj) -> list:
        out = self._exchange(obj)
        self._drain()
        return out


def check_divides(size: int, world: int, what: str) -> None:
    if size % world:
        raise LightGBMError("%s: a dimension of %d does not divide over %d "
                            "ranks" % (what, size, world))


_logged_rules = set()


def _log_once(rule: str, msg: str) -> None:
    if rule not in _logged_rules:
        _logged_rules.add(rule)
        Log.info(msg)


class DistGroup:
    """One rank of a ``torch.distributed`` process group (the default
    group, which ``init`` creates). ``backend`` is the group's: under gloo
    CUDA tensors are staged through pinned host memory and reduce-scatter
    is an all-reduce and a slice, by rule."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.counter = PayloadCounter()
        self._staging = {}

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend takes: ``t`` itself, or under gloo a
        pinned host copy of a CUDA tensor."""
        if self.backend != "gloo" or not t.is_cuda:
            return t
        _log_once("stage", "gloo takes host tensors: CUDA tensors of the "
                  "collectives cross through pinned host memory")
        self.counter.staged += 1
        # one pinned buffer a dtype, grown to the largest tensor staged: a
        # collective returns before the next one stages
        buf = self._staging.get(t.dtype)
        if buf is None or buf.numel() < t.numel():
            buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            self._staging[t.dtype] = buf
        staged = buf[:t.numel()].view(t.shape)
        staged.copy_(t)
        return staged

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        with _Timed(self.counter, "all_reduce", t, t.numel()):
            src = t.contiguous()
            buf = self._stage(src)
            dist.all_reduce(buf)
            if buf is not t:
                t.copy_(buf)
        return t

    def reduce_scatter_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist
        size = t.shape[dim]
        check_divides(size, self.world, "reduce_scatter")
        blk = size // self.world
        gloo = self.backend == "gloo"
        with _Timed(self.counter, "reduce_scatter", t,
                    t.numel() / self.world,
                    t.numel() if gloo else None):
            if gloo:
                _log_once("rs", "gloo has no reduce-scatter: it runs as an "
                          "all-reduce and a slice")
                self.counter.emulated_rs += 1
                buf = self._stage(t.contiguous())
                dist.all_reduce(buf)
                out = buf.narrow(dim, self.rank * blk, blk).to(
                    t.device, copy=True)
            else:
                parts = list(t.movedim(dim, 0).contiguous().chunk(
                    self.world))
                out = torch.empty_like(parts[0])
                dist.reduce_scatter(out, parts)
                out = out.movedim(0, dim).contiguous()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        with _Timed(self.counter, "all_gather", t, t.numel() * self.world):
            src = self._stage(t.contiguous())
            outs = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(outs, src)
            out = torch.stack(outs).to(t.device)
        return out

    def all_gather_object(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


_group: Optional[DistGroup] = None
_num_machines = 1
_rank = 0


def rank_device(rank: int, device: torch.device) -> torch.device:
    """The card of ``rank`` on its host where ``device`` is CUDA without
    an index: ``cuda:(rank % cards)``; ``device`` otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return device


def dist_backend(world: int, device: torch.device) -> str:
    """NCCL where every rank has a card of its own (CUDA, and at least
    ``world`` cards on the host), gloo otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init(machines: str = "", local_listen_port: int = 12400,
         time_out: int = 120, num_machines: int = 1,
         device=None) -> Optional[DistGroup]:
    """Network::Init: with ``num_machines`` 1 a no-op; with more, this
    process joins the group as rank ``LIGHTGBM_TPU_RANK`` (0 when unset)
    through a TCP rendezvous at the first entry of ``machines``
    (``127.0.0.1:local_listen_port`` when the list is empty). ``device``
    is the rank's (``cuda`` by default: card ``rank % cards``)."""
    global _group, _num_machines, _rank
    if num_machines <= 1:
        return None
    hosts = [m.strip() for m in machines.split(",") if m.strip()]
    if hosts and len(hosts) != num_machines:
        raise LightGBMError("machines list has %d entries but "
                            "num_machines=%d" % (len(hosts), num_machines))
    master = hosts[0] if hosts else "127.0.0.1:%d" % local_listen_port
    rank = int(os.environ.get("LIGHTGBM_TPU_RANK", "0"))
    if not 0 <= rank < num_machines:
        raise LightGBMError("LIGHTGBM_TPU_RANK=%d outside [0, %d)"
                            % (rank, num_machines))
    import torch.distributed as dist
    if _group is not None:
        free()
    dev = rank_device(rank, torch.device("cuda" if device is None
                                         else device))
    backend = dist_backend(num_machines, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method="tcp://" + master,
                            world_size=num_machines, rank=rank,
                            timeout=timedelta(seconds=time_out))
    _group = DistGroup(rank, num_machines, dev, backend)
    _num_machines, _rank = num_machines, rank
    Log.info("Distributed init: rank %d / %d over %s (rendezvous %s)",
             rank, num_machines, backend, master)
    return _group


def free() -> None:
    """Network::Dispose: leave the process group."""
    global _group, _num_machines, _rank
    if _group is not None:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    _group, _num_machines, _rank = None, 1, 0


def group() -> Optional[DistGroup]:
    """This process's group endpoint, None outside ``init``."""
    return _group


def num_machines() -> int:
    return _num_machines


def rank() -> int:
    return _rank


def check_model_agreement(digest: str, comm=None) -> List[str]:
    """Gather every rank's model digest and fail loudly when two differ:
    data-parallel training commits on every rank the trees of the summed
    histograms, so a mismatch means real divergence. Returns the rank
    ordered digests; ``[digest]`` without a group."""
    comm = comm if comm is not None else _group
    if comm is None or comm.world <= 1:
        return [str(digest)]
    digests = [str(d) for d in comm.all_gather_object(str(digest))]
    if len(set(digests)) > 1:
        raise LightGBMError(
            "model disagreement across ranks: "
            + ", ".join("rank %d=%s" % (i, d[:16])
                        for i, d in enumerate(digests)))
    return digests
