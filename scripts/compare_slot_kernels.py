"""The slot or partitioned-layout histogram kernels of two checkouts on one
card, in turns.

``--kernel slots`` (the default) takes chip_smoke.py's slot shapes
(``chip_smoke.SLOT_SHAPES``: 1,000,000 x 28 rows of 255 bins, half of them
active; K=3 at S = 2, 16, 128 and 254, K=6 at S = 16); ``--kernel part``
takes its partitioned-layout shapes (``chip_smoke.PART_SHAPES``: the
layout of 1,000,000 rows at 255 leaves, Np = 1,525,760, F = 28, B = 255;
A: S = 1, every row-holding tile active; B: S = 16, all; C: S = 16, half;
D: S = 16, an eighth). At each shape it holds this checkout's wrapper and
that of ``--against`` against the plain version (``chip_smoke.
check_slot_result`` or ``check_part_result``), then measures the two in
turns, A B B A for two rounds: the event time (median of 20
CUDA-event-timed calls with the L2 evicted), the device time by launch
(torch.profiler) and the host time of back-to-back calls; beside them,
once a shape, the library yardstick (one ``index_add_``:
``chip_smoke.slot_library`` or ``part_library``) and the memory bound.
Prints one line per shape and checkout, the card's name and power limit,
then one JSON line with every number.

    python3 scripts/compare_slot_kernels.py --against OTHER_CHECKOUT \
        [--kernel slots|part] [--rounds R]

It imports ``chip_smoke`` and ``lightgbm_tpu_torch`` from the directory it
is run from and loads the other checkout's port under another module name
(``time_iterations.load_port``); each builds its own kernels. Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def slot_shapes(cs, kernels, dev):
    """(label, calls to check and time given a kernels module, the
    library call, bound ms, what bounds it, the shape's fields) for each
    slot shape."""
    for n, f, b, k, s in cs.SLOT_SHAPES:
        xb, slot, v, sel = cs.slot_inputs(dev, n, f, b, k, s)
        want = cs.slot_plain(xb, slot, v, sel, b, s, k)
        absum = cs.slot_plain(xb, slot, v.abs(), sel, b, s, k)

        def call(kern, xb=xb, slot=slot, v=v, sel=sel, b=b, s=s, k=k):
            return cs.slot_call(kern, xb, slot, v, sel, b, s, k)

        def check(got, want=want, absum=absum, s=s, k=k):
            return cs.check_slot_result(got, want, absum, s, k)
        library, n_active = cs.slot_library(xb, slot, v, sel, b, s, k)
        bound_ms, bound_by = cs.bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        yield ("slots K=%d S=%d" % (k, s), call, check, library, bound_ms,
               bound_by, {"n": n, "F": f, "B": b, "K": k, "S": s,
                          "active": n_active})


def part_shapes(cs, kernels, dev):
    """As ``slot_shapes``, for each partitioned-layout shape."""
    f, b = cs.NUM_FEATURES, 255
    for label, s, share in cs.PART_SHAPES:
        inputs, tile = cs.part_inputs(dev, s, share)
        want = cs.part_plain(inputs, b, s, tile)
        absum = cs.part_plain(inputs, b, s, tile, inputs[2].abs())

        def call(kern, inputs=inputs, s=s, tile=tile):
            return cs.part_call(kern, inputs, b, s, tile)

        def check(got, want=want, absum=absum, ts=inputs[3], s=s):
            return cs.check_part_result(got, want, absum, ts, s)
        library, active_tiles, n_act = cs.part_library(inputs, b, s, tile)
        n_tiles = int(inputs[3].numel())
        bound_ms, bound_by = cs.bound(
            kernels.part_hist_bytes(active_tiles, n_tiles, tile, f, b, s),
            n_act * f * 6)
        yield ("part %s S=%d" % (label, s), call, check, library, bound_ms,
               bound_by, {"shape": label, "Np": int(inputs[0].shape[1]),
                          "F": f, "B": b, "S": s,
                          "active_tiles": active_tiles})


def main() -> int:
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="another checkout whose kernels are timed in "
                         "turns with this one's")
    ap.add_argument("--kernel", choices=("slots", "part"), default="slots")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_slot_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lightgbm_tpu_torch.core import kernels
    from time_iterations import load_port

    other = load_port(args.against, "lightgbm_tpu_torch_against")
    import lightgbm_tpu_torch_against.core.kernels as other_kernels
    ports = {"this": kernels, "against": other_kernels}
    dev = torch.device("cuda", 0)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    shapes = slot_shapes if args.kernel == "slots" else part_shapes
    results = []
    for (label, call, check, library, bound_ms, bound_by,
         fields) in shapes(chip_smoke, kernels, dev):
        calls, taken = {}, {}
        for name, kern in ports.items():
            def bound_call(kern=kern):
                return call(kern)
            check(bound_call())
            torch.cuda.synchronize()
            calls[name] = bound_call
            taken[name] = {"ms": [], "host_ms": [], "device_split": []}
        order = list(ports)
        for i in range(2 * args.rounds):
            for name in (order if i % 2 == 0 else order[::-1]):
                t = taken[name]
                t["ms"].append(chip_smoke.time_ms(calls[name], flush))
                t["host_ms"].append(chip_smoke.host_ms(calls[name]))
                t["device_split"].append(
                    chip_smoke.device_split(calls[name], flush))
        row = dict(fields, library_ms=chip_smoke.time_ms(library, flush),
                   library_host_ms=chip_smoke.host_ms(library),
                   bound_ms=bound_ms, bound_by=bound_by)
        print("%s index_add_: event %.4f ms, host %.4f ms; bound %.4f ms "
              "(%s)" % (label, row["library_ms"], row["library_host_ms"],
                        bound_ms, bound_by), flush=True)
        for name, t in taken.items():
            splits = [d for d in t["device_split"] if d is not None]
            launches = sorted({key for d in splits for key in d})
            split = ({key: statistics.median(d.get(key, 0.0) for d in splits)
                      for key in launches} if splits else None)
            row[name] = {"ms": statistics.median(t["ms"]),
                         "host_ms": statistics.median(t["host_ms"]),
                         "device_ms": (None if split is None
                                       else sum(split.values())),
                         "device_split": split, "turns": t}
            print("%s %s: event %.4f ms (turns %s), device %s ms (%s), "
                  "host %.4f ms"
                  % (label, name, row[name]["ms"],
                     " ".join("%.4f" % x for x in t["ms"]),
                     chip_smoke.fmt(row[name]["device_ms"]),
                     chip_smoke.fmt_split(split), row[name]["host_ms"]),
                  flush=True)
        results.append(row)
        del calls, library, call, check
    card = chip_smoke.card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "kernel": args.kernel,
                      "this": os.getcwd(),
                      "against": os.path.abspath(args.against),
                      "shapes": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
