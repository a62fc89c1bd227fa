"""The slot histogram kernels of two checkouts on one card, in turns.

For each of chip_smoke.py's slot shapes (``chip_smoke.SLOT_SHAPES``:
1,000,000 x 28 rows of 255 bins, half of them active; K=3 at S = 2, 16,
128 and 254, K=6 at S = 16) it holds this checkout's slot wrapper and
that of ``--against`` against the plain version (``chip_smoke.
check_slot_result``), then measures the two in turns, A B B A for two
rounds: the event time (median of 20 CUDA-event-timed calls with the L2
evicted), the device time by launch (torch.profiler) and the host time of
back-to-back calls; beside them, once a shape, the library yardstick
(``chip_smoke.slot_library``: one ``index_add_``) and the memory bound.
Prints one line per shape and checkout, the card's name and power limit,
then one JSON line with every number.

    python3 scripts/compare_slot_kernels.py --against OTHER_CHECKOUT \
        [--rounds R]

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


def main() -> int:
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", required=True,
                    help="another checkout whose slot kernels are timed in "
                         "turns with this one's")
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
    results = []
    for n, f, b, k, s in chip_smoke.SLOT_SHAPES:
        xb, slot, v, sel = chip_smoke.slot_inputs(dev, n, f, b, k, s)
        want = chip_smoke.slot_plain(xb, slot, v, sel, b, s, k)
        absum = chip_smoke.slot_plain(xb, slot, v.abs(), sel, b, s, k)
        calls, taken = {}, {}
        for name, kern in ports.items():
            def call(kern=kern):
                return chip_smoke.slot_call(kern, xb, slot, v, sel, b, s, k)
            got = call()
            torch.cuda.synchronize()
            chip_smoke.check_slot_result(got, want, absum, s, k)
            calls[name] = call
            taken[name] = {"ms": [], "host_ms": [], "device_split": []}
        del got, want, absum
        library, n_active = chip_smoke.slot_library(xb, slot, v, sel, b, s, k)
        order = list(ports)
        for i in range(2 * args.rounds):
            for name in (order if i % 2 == 0 else order[::-1]):
                t = taken[name]
                t["ms"].append(chip_smoke.time_ms(calls[name], flush))
                t["host_ms"].append(chip_smoke.host_ms(calls[name]))
                t["device_split"].append(
                    chip_smoke.device_split(calls[name], flush))
        bound_ms, bound_by = chip_smoke.bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        row = {"n": n, "F": f, "B": b, "K": k, "S": s, "active": n_active,
               "library_ms": chip_smoke.time_ms(library, flush),
               "library_host_ms": chip_smoke.host_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        print("slots K=%d S=%d index_add_: event %.4f ms, host %.4f ms; "
              "bound %.4f ms (%s)" % (k, s, row["library_ms"],
                                      row["library_host_ms"], bound_ms,
                                      bound_by), flush=True)
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
            print("slots K=%d S=%d %s: event %.4f ms (turns %s), device %s "
                  "ms (%s), host %.4f ms"
                  % (k, s, name, row[name]["ms"],
                     " ".join("%.4f" % x for x in t["ms"]),
                     chip_smoke.fmt(row[name]["device_ms"]),
                     chip_smoke.fmt_split(split), row[name]["host_ms"]),
                  flush=True)
        results.append(row)
        del xb, slot, v, sel, calls, library
    card = chip_smoke.card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "this": os.getcwd(),
                      "against": os.path.abspath(args.against),
                      "shapes": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
