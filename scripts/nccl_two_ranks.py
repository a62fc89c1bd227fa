"""What NCCL answers when two processes put a group on one card.

The port's ``DistGroup`` (``lightgbm_tpu_torch/parallel/network.py``)
takes NCCL only where each rank has a card of its own and gloo otherwise,
by rule. This script records why: it starts two processes of itself, each
of which puts an NCCL group on ``cuda:0`` and all-reduces 4 floats, and
prints each rank's answer (NCCL 2.28.9 on an H100 refuses with
``ncclInvalidUsage ... Duplicate GPU detected``), then the card's name
and power limit.

    python3 scripts/nccl_two_ranks.py

Exits 1 without CUDA or when a rank gave no answer; 0 once both ranks
have answered, whatever NCCL said.
"""
import os
import socket
import subprocess
import sys
import tempfile
from datetime import timedelta

RANKS = 2
TIMEOUT_S = 60


def rank_main(rank: int, port: int, out: str) -> int:
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method="tcp://127.0.0.1:%d"
                                % port, world_size=RANKS, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        answer = "succeeded: %s" % t.tolist()
    except Exception as e:  # noqa: BLE001 - the answer is the result
        answer = "%s: %s" % (type(e).__name__, " ".join(str(e).split()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "w") as f:
        f.write(answer)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, "rank_%d.txt" % r) for r in range(RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank", str(r), str(port), outs[r]])
                 for r in range(RANKS)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=TIMEOUT_S + 30))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        answered = all(os.path.exists(p) for p in outs)
        for r, path in enumerate(outs):
            answer = (open(path).read() if os.path.exists(path)
                      else "no answer (exit %s)" % rcs[r])
            print("NCCL, two ranks on cuda:0, rank %d: %s" % (r, answer))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print("torch %s, NCCL %s" % (torch.__version__, nccl))
    return 0 if answered else 1


if __name__ == "__main__":
    sys.exit(main())
