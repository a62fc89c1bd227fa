"""Rank groups and the parallel learners' parts, in the port and in the JAX
package, on the CPU.

- A packed best record is the JAX package's ``pack_best_record`` bit for
  bit (float32 lanes), and packing and unpacking are lossless in float32
  and float64 (int64 fields bitcast, 32-bit words kept whole).
- The election takes the largest gain, among equal ones the lowest
  feature index, then the lowest rank (the JAX package's first maximum
  where ranks hold contiguous feature blocks), the same on every rank;
  ``sync_best_split`` hands every rank the winner's record, as the JAX
  package's argmax-allreduce does.
- ``ThreadGroup``'s collectives: sums in rank order, the same bytes on
  every rank; the reduce-scatter's blocks; the all-gathers; a rank that
  fails aborts its peers instead of hanging them. Its payload counter
  follows the JAX package's rules (obs/perfgate.py:113-121).
- The payload pins: the port's frontier grower on the perfgate workload
  (lightgbm_tpu/analysis/jaxpr_audit.py:159-200: 256 rows, 16 features,
  16 bins, 8 ranks, num_leaves 7, max_depth 3) receives in a wave of k
  splits k/4 of PERF_COUNTERS.json's ``wave_payload_f32_serial`` 3072,
  ``_data_rs`` 1728 and ``_voting`` 1536 floats (tol 0): the JAX package
  compiles its wave at the width 2^(max_depth-1) = 4, whose payload the
  pins are, while the port's waves are cut to the splits they commit
  (here 1, 2 and 3).
- The layout: ``build_mesh`` and its warn-once serial fallback, rows
  padded to a multiple of the ranks, the bin-balanced column assignment,
  ``check_model_agreement``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.core.split import BestSplit as JBestSplit
from lightgbm_tpu.parallel.learners import pack_best_record as jax_pack
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.core.grow import GrowParams
from lightgbm_tpu_torch.core.grow_frontier import grow_tree_frontier
from lightgbm_tpu_torch.core.split import BestSplit, FeatureMeta, SplitParams
from lightgbm_tpu_torch.log import LightGBMError, Log
from lightgbm_tpu_torch.parallel import learners, mesh, network

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_threads(world, fn, timeout_s=60.0):
    """``fn(comm)`` on each rank of a ThreadGroup of ``world``, in threads;
    returns the ranks' results (an exception in place of a failed one)."""
    group = network.ThreadGroup.group(world, timeout_s=timeout_s)
    out = [None] * world

    def run(r):
        try:
            out[r] = fn(group[r])
        except BaseException as e:  # noqa: BLE001 - returned to the test
            out[r] = e
            group[r].abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out


def _record(k=3, dtype=torch.float32, seed=0):
    r = np.random.RandomState(seed)
    f = lambda: torch.as_tensor(r.randn(k), dtype=dtype)
    return BestSplit(
        gain=torch.as_tensor([1.5, float("-inf"), 0.0][:k], dtype=dtype),
        feature=torch.as_tensor([7, 0, 2 ** 30][:k]),
        threshold=torch.as_tensor([-1, 255, 3][:k]),
        default_left=torch.as_tensor([True, False, True][:k]),
        left_sum_grad=f(), left_sum_hess=f(), left_count=f(),
        right_sum_grad=f(), right_sum_hess=f(), right_count=f(),
        left_output=f(), right_output=f(),
        is_categorical=torch.as_tensor([False, True, False][:k]),
        cat_bitset=torch.as_tensor(np.array(
            [[0xFFFFFFFF] * 8, [0] * 8, [0x80000001] * 8][:k], np.int64)))


def test_record_is_the_jax_packages_bit_for_bit():
    bs = _record()
    jbs = JBestSplit(*[
        jnp.asarray(v.numpy().astype(np.uint32)) if name == "cat_bitset"
        else jnp.asarray(v.numpy().astype(np.int32))
        if name in ("feature", "threshold") else jnp.asarray(v.numpy())
        for name, v in zip(BestSplit._fields, bs)])
    ours = learners.pack_best_record(bs)
    assert ours.shape == (3, learners.RECORD_LANES)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy().view(np.uint32),
                                  np.asarray(jax_pack(jbs)).view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_record_round_trip_is_lossless(dtype):
    bs = _record(dtype=dtype)
    rec = learners.pack_best_record(bs)
    assert rec.dtype == dtype
    back = learners.unpack_best_record(rec)
    for name, a, b in zip(BestSplit._fields, bs, back):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_election_takes_the_lowest_rank_among_equal_gains():
    gains = [1.0, 3.0, 2.0, 3.0]

    def fn(comm):
        bs = _record(k=1, seed=comm.rank)
        bs = bs._replace(gain=torch.tensor([gains[comm.rank]]),
                         feature=torch.tensor([10 + comm.rank]))
        return learners.elect_best_records(bs, comm)

    out = on_threads(4, fn)
    for won in out:
        assert won.feature.tolist() == [11]
        want = learners.pack_best_record(_record(k=1, seed=1)._replace(
            gain=torch.tensor([3.0]), feature=torch.tensor([11])))
        np.testing.assert_array_equal(
            learners.pack_best_record(won).numpy().view(np.uint32),
            want.numpy().view(np.uint32))


def test_election_takes_the_lowest_feature_among_equal_gains():
    """Feature-parallel's ranks hold columns in any order: the election
    takes the lowest feature index among the largest gains, the serial
    search's tie-break."""
    gains, features = [3.0, 3.0, 1.0, 3.0], [13, 9, 2, 11]

    def fn(comm):
        bs = _record(k=1, seed=comm.rank)._replace(
            gain=torch.tensor([gains[comm.rank]]),
            feature=torch.tensor([features[comm.rank]]))
        return learners.elect_best_records(bs, comm)

    for won in on_threads(4, fn):
        assert won.feature.tolist() == [9]
        assert won.left_sum_grad.tolist() == _record(
            k=1, seed=1).left_sum_grad.tolist()


def test_sync_best_split_is_the_argmax_allreduce():
    """Every rank gets, leaf by leaf, the record of the rank with the
    largest gain (first maximum), as the JAX package's sync_best_split
    broadcasts the winner's fields."""
    r = np.random.RandomState(3)
    gains = r.choice([0.5, 1.0, 2.0], size=(5, 4)).astype(np.float32)

    def fn(comm):
        bs = _record(k=3, seed=comm.rank)
        bs = BestSplit(*[torch.cat([v, v[:1]]) for v in bs])
        bs = bs._replace(gain=torch.as_tensor(gains[comm.rank]))
        return learners.sync_best_split(bs, comm)

    out = on_threads(5, fn)
    winners = np.argmax(gains, axis=0)
    for won in out:
        for leaf, w in enumerate(winners):
            src = _record(k=3, seed=int(w))
            src = BestSplit(*[torch.cat([v, v[:1]]) for v in src])
            assert float(won.gain[leaf]) == gains[w, leaf]
            for name in ("feature", "threshold", "left_sum_grad",
                         "right_output", "cat_bitset"):
                np.testing.assert_array_equal(
                    getattr(won, name)[leaf].numpy(),
                    getattr(src, name)[leaf].numpy(), err_msg=name)


def test_thread_group_collectives():
    world = 4

    def fn(comm):
        t = torch.arange(8, dtype=torch.float32) * (comm.rank + 1) + 0.1
        s = comm.all_reduce_sum_(t.clone())
        rs = comm.reduce_scatter_sum(t.reshape(2, 4).clone(), 1)
        g = comm.all_gather(torch.tensor([comm.rank, 2 * comm.rank]))
        objs = comm.all_gather_object({"rank": comm.rank})
        return s, rs, g, objs, comm.counter.summary()

    out = on_threads(world, fn)
    parts = [torch.arange(8, dtype=torch.float32) * (r + 1) + 0.1
             for r in range(world)]
    want = parts[0].clone()
    for p in parts[1:]:
        want += p
    for rank, (s, rs, g, objs, counts) in enumerate(out):
        np.testing.assert_array_equal(s.numpy(), want.numpy())
        np.testing.assert_array_equal(
            rs.numpy(), want.reshape(2, 4)[:, rank:rank + 1].numpy())
        assert g.tolist() == [[r, 2 * r] for r in range(world)]
        assert objs == [{"rank": r} for r in range(world)]
        # all-reduce: the operand; reduce-scatter: operand / P; an integer
        # all-gather counts as a collective and carries no payload
        assert counts["payload"] == {"all_reduce": 8.0,
                                     "reduce_scatter": 2.0}
        assert counts["calls"] == {"all_reduce": 1, "reduce_scatter": 1,
                                   "all_gather": 1}


def test_thread_group_under_stress():
    """More ranks than cores, the interpreter switching threads every
    microsecond, 20 rounds of collectives: every rank receives every
    round's exact sums and blocks (a slot overwritten before its peers
    read it would break them)."""
    import sys
    world, rounds = (os.cpu_count() or 4) + 2, 20
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def fn(comm):
            got = []
            for i in range(rounds):
                t = torch.full((world,), float(comm.rank * rounds + i))
                got.append((comm.all_reduce_sum_(t.clone())[0].item(),
                            comm.reduce_scatter_sum(t.clone(), 0).item()))
            return got
        out = on_threads(world, fn, timeout_s=120.0)
    finally:
        sys.setswitchinterval(old)
    for i in range(rounds):
        want = float(sum(r * rounds + i for r in range(world)))
        for got in out:
            assert not isinstance(got, BaseException), got
            assert got[i] == (want, want)


def test_a_failing_rank_aborts_its_peers():
    def fn(comm):
        if comm.rank == 2:
            raise ValueError("rank 2 fails")
        return comm.all_reduce_sum_(torch.ones(3))

    out = on_threads(3, fn, timeout_s=30.0)
    assert isinstance(out[2], ValueError)
    for r in (0, 1):
        assert isinstance(out[r], LightGBMError)
        assert "rank 2 failed" in str(out[r])


def test_thread_ranks_on_one_card_refuse():
    with pytest.raises(LightGBMError, match="a card each"):
        network.ThreadGroup.group(2, ["cuda:0", "cuda:0"])


# ------------------------------------------------------------- payload pins
def _perfgate_workload():
    """lightgbm_tpu/analysis/jaxpr_audit.py:185-210 with 16 features."""
    r = np.random.RandomState(0)
    n, f, b = 256, 16, 16
    xb = r.randint(0, b, (n, f)).astype(np.uint8)
    g = r.randn(n).astype(np.float32)
    meta = FeatureMeta(
        num_bin=torch.full((f,), b, dtype=torch.int64),
        missing_type=torch.zeros(f, dtype=torch.int64),
        default_bin=torch.zeros(f, dtype=torch.int64),
        penalty=torch.ones(f), monotone=torch.zeros(f, dtype=torch.int64))
    sp = SplitParams(lambda_l1=0.0, lambda_l2=0.0, max_delta_step=0.0,
                     min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3,
                     min_gain_to_split=0.0)
    params = GrowParams(num_leaves=7, num_bins=b, max_depth=3, split=sp,
                        hist_impl="plain")
    return xb, g, meta, params


def _pins():
    with open(os.path.join(ROOT, "PERF_COUNTERS.json")) as fh:
        c = json.load(fh)["counters"]
    return {k: c["wave_payload_f32_" + k] for k in ("serial", "data_rs",
                                                    "voting")}


LEARNER_OF_PIN = {"serial": ("psum", 20), "data_rs": ("data_rs", 20),
                  "voting": ("voting", 2)}


@pytest.mark.parametrize("pin", sorted(LEARNER_OF_PIN))
def test_wave_payload_equals_the_jax_pins(pin):
    xb, g, meta, params = _perfgate_workload()
    kind, top_k = LEARNER_OF_PIN[pin]
    pins = _pins()
    assert pins[pin]["tol"] == 0 and pins[pin]["mode"] == "exact"
    world, n = 8, xb.shape[0]
    blk = n // world
    fmask = torch.ones(xb.shape[1], dtype=torch.bool)

    def fn(comm):
        rows = slice(comm.rank * blk, (comm.rank + 1) * blk)
        ones = torch.ones(blk)
        tree, _ = grow_tree_frontier(
            torch.as_tensor(xb[rows]), torch.as_tensor(g[rows]), ones, ones,
            meta, fmask, params,
            dist=learners.Distributed(comm, kind, top_k=top_k))
        return tree, comm.counter.summary()

    out = on_threads(world, fn)
    tree, counts = out[0]
    assert all(o[1]["waves"] == counts["waves"] for o in out)
    assert counts["wave_splits"] == [1, 2, 3]
    # the JAX pin is its compiled wave of 4 splits; the port's waves hold
    # the splits they make, so the pin is held a split
    per_split = pins[pin]["value"] / 4
    for k, payload in zip(counts["wave_splits"], counts["waves"]):
        assert payload == k * per_split, (counts, pin)
    # thread ranks read only their share: the transport moved the payload
    assert counts["waves_moved"] == counts["waves"]
    assert tree.num_leaves == 7


# ------------------------------------------------------------- layout
def test_build_mesh_plans():
    cpu = torch.device("cpu")
    plan = mesh.build_mesh(Config({"tree_learner": "voting",
                                   "mesh_shape": [8]}), cpu)
    assert plan == mesh.MeshPlan(8, "data", "threads", (cpu,) * 8)
    plan = mesh.build_mesh(Config({"tree_learner": "feature",
                                   "mesh_shape": [3]}), cpu)
    assert (plan.world, plan.axis) == (3, "feature")
    with pytest.raises(NotImplementedError, match="#13 slice b"):
        mesh.build_mesh(Config({"mesh_shape": [2, 2]}), cpu)
    assert mesh.build_mesh(Config({}), cpu) is None


def test_single_device_fallback_warns_once():
    """A parallel tree_learner with one visible device and no mesh_shape
    trains serially and says so once (mesh.py:76-86 of the JAX
    package)."""
    msgs = []
    mesh._warned_fallback = False
    Log.reset_callback(msgs.append)
    try:
        for learner in ("voting", "data"):
            assert mesh.build_mesh(Config({"tree_learner": learner,
                                           "verbosity": 0}),
                                   torch.device("cpu")) is None
    finally:
        Log.reset_callback(None)
        mesh._warned_fallback = False
    warned = [m for m in msgs if "falls back to serial" in m]
    assert len(warned) == 1 and "voting" in warned[0]


@pytest.mark.parametrize("n,world", [(2001, 8), (600, 8), (16, 4), (5, 8)])
def test_row_layout_pads_to_a_multiple_of_the_ranks(n, world):
    lays = [mesh.row_layout(n, world, r, "data") for r in range(world)]
    assert all(l.num_padded % world == 0 and l.num_padded - n < world
               for l in lays)
    assert [l.begin for l in lays] == [r * lays[0].num_local
                                       for r in range(world)]
    a = np.arange(n) + 1
    got = np.concatenate([mesh.rows_of(a, l) for l in lays])
    np.testing.assert_array_equal(got[:n], a)
    assert not got[n:].any()
    assert mesh.row_layout(n, world, 1, "feature") == (n, n, 0, n)


def test_column_assignment_is_bin_balanced():
    num_bin = [255, 3, 64, 64, 1, 200, 17, 2, 128]
    assign = mesh.assign_columns(num_bin, 3)
    assert sorted(sum(assign, [])) == list(range(len(num_bin)))
    # the greedy rule: descending bin counts, each to the least loaded
    loads = [0, 0, 0]
    want = [[], [], []]
    for j in sorted(range(len(num_bin)), key=lambda j: -num_bin[j]):
        r = int(np.argmin(loads))
        want[r].append(j)
        loads[r] += num_bin[j]
    assert assign == want


def test_check_model_agreement():
    assert network.check_model_agreement("solo") == ["solo"]
    ok = on_threads(2, lambda c: network.check_model_agreement("abc", c))
    assert ok == [["abc", "abc"]] * 2
    bad = on_threads(2, lambda c: network.check_model_agreement(
        "abc" if c.rank == 0 else "def", c))
    for e in bad:
        assert isinstance(e, LightGBMError)
        assert "rank 0" in str(e) and "rank 1" in str(e)
