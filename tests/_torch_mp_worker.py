"""One rank of the port's two-process training (tests/test_torch_parallel_mp.py).

Each rank is an OS process that joins a ``torch.distributed`` group over
gloo on the CPU (``num_machines=2``, the first of ``machines`` the
rendezvous, the rank from ``LIGHTGBM_TPU_RANK``), loads the whole of
tests/mp_worker.py's 4,096 x 8 binary data and trains 5 rounds with
``tree_learner=data`` on its block of the rows. Each rank writes its
predictions of the first 256 rows, its model digests and its payload
counter to ``MP_TEST_OUT.<rank>``, then one reduce-scatter over the group
and its count.

With ``MP_TEST_MODE=hist`` (tests/test_torch_kernels_cuda.py, on a card)
each rank instead builds one histogram of its own rows with
``histogram.cu`` on ``cuda:0`` and all-reduces it over the group, which
two ranks on one card take over gloo through pinned host memory; it saves
both to ``MP_TEST_OUT.<rank>.npz``.
"""
import json
import os
import sys

import numpy as np
import torch


def hist_rank(rank: int, port: str) -> None:
    from lightgbm_tpu_torch.core import kernels
    from lightgbm_tpu_torch.parallel import network
    comm = network.init("127.0.0.1:%s,127.0.0.1:0" % port, num_machines=2,
                        time_out=60, device="cuda")
    r = np.random.RandomState(rank)
    xb = torch.as_tensor(r.randint(0, 32, (4096, 6)).astype(np.uint8),
                         device=comm.device)
    vals = torch.as_tensor(r.randn(4096, 3).astype(np.float32),
                           device=comm.device)
    own = kernels.build_histogram_cuda(xb, vals, 32)
    summed = comm.all_reduce_sum_(own.clone())
    np.savez("%s.%d.npz" % (os.environ["MP_TEST_OUT"], rank),
             own=own.cpu().numpy(), summed=summed.cpu().numpy(),
             backend=comm.backend, staged=comm.counter.staged)
    network.free()


def main() -> None:
    torch.set_num_threads(1)
    rank = int(os.environ["LIGHTGBM_TPU_RANK"])
    port = os.environ["MP_TEST_PORT"]
    if os.environ.get("MP_TEST_MODE") == "hist":
        hist_rank(rank, port)
        sys.exit(0)
    import lightgbm_tpu_torch as tlgb
    r = np.random.RandomState(0)
    x = r.randn(4096, 8).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float32)
    params = {"objective": "binary", "tree_learner": "data",
              "num_machines": 2, "num_leaves": 15, "verbosity": -1,
              "machines": "127.0.0.1:%s,127.0.0.1:0" % port}
    bst = tlgb.train(params, tlgb.Dataset(x, label=y, device="cpu"),
                     num_boost_round=5, device="cpu")
    impl = bst._impl
    comm = impl._comm
    out = {"pred": bst.predict(x[:256], raw_score=True).tolist(),
           "digests": bst.model_digests, "world": comm.world,
           "backend": comm.backend, "num_data": impl.num_data,
           "counter": comm.counter.summary(),
           "train": bst.eval_train()[0][2]}
    # one reduce-scatter of a [4, 3] tensor, which gloo runs as an
    # all-reduce and a slice: the rank's rows of the sum, and its count
    comm.counter.reset()
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (rank + 1)
    out["rs"] = comm.reduce_scatter_sum(t, 0).tolist()
    out["rs_counter"] = comm.counter.summary()
    with open("%s.%d" % (os.environ["MP_TEST_OUT"], rank), "w") as f:
        json.dump(out, f)
    # leave the group before exiting, as a rank of a real training does
    from lightgbm_tpu_torch.parallel import network
    network.free()
    sys.exit(0)


if __name__ == "__main__":
    main()
