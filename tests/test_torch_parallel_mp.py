"""Two processes of the port, one rank each, over gloo on the CPU.

tests/mp_worker.py's workload (4,096 x 8 binary, ``num_leaves=15``, 5
rounds): each rank of ``tests/_torch_mp_worker.py`` joins the group
through ``num_machines=2`` and ``machines`` (the first entry the
rendezvous, a free port; the rank from ``LIGHTGBM_TPU_RANK``), keeps its
2,048 rows and trains with ``tree_learner=data``. Both ranks' raw
predictions are within 2e-4 of the JAX package's one-process training,
their model digests agree, and each rank received the all-reduced
histograms (its payload counter). A reduce-scatter over the group returns
each rank's block of the sum, counted by the JAX package's rule and by
what gloo moved.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import socket
import subprocess
import sys

import numpy as np

import lightgbm_tpu as jlgb

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_train_the_one_process_model(tmp_path):
    out = str(tmp_path / "rank")
    env = dict(os.environ, MP_TEST_PORT=str(_free_port()), MP_TEST_OUT=out,
               OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_mp_worker.py")],
        env=dict(env, LIGHTGBM_TPU_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    ranks = []
    for r in range(2):
        with open("%s.%d" % (out, r)) as f:
            ranks.append(json.load(f))

    r = np.random.RandomState(0)
    x = r.randn(4096, 8).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.float32)
    jb = jlgb.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1}, jlgb.Dataset(x, label=y),
                    num_boost_round=5)
    want = np.asarray(jb.predict(x[:256], raw_score=True), np.float64)
    for got in ranks:
        assert got["world"] == 2 and got["backend"] == "gloo"
        assert got["num_data"] == 2048
        np.testing.assert_allclose(got["pred"], want, rtol=0, atol=2e-4)
        assert got["digests"] == ranks[0]["digests"]
        assert len(set(got["digests"])) == 1
        assert got["counter"]["calls"]["all_reduce"] > 0
    assert ranks[0]["pred"] == ranks[1]["pred"]
    assert ranks[0]["train"] == ranks[1]["train"]
    # gloo's reduce-scatter is an all-reduce and a slice: the JAX package's
    # rule counts the operand over P (6 floats), the transport received
    # the whole operand (12)
    whole = np.arange(12, dtype=np.float32).reshape(4, 3) * 3
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rs"], whole[2 * rank:2 * rank + 2])
        rs = got["rs_counter"]
        assert rs["calls"] == {"reduce_scatter": 1} and rs["emulated_rs"] == 1
        assert rs["payload"] == {"reduce_scatter": 6.0}
        assert rs["moved"] == {"reduce_scatter": 12.0}
