"""Probes of the partitioned-layout kernel's design choices on one card.

    python3 scripts/probe_part_kernel.py [--rounds R]

Builds variants of ``lightgbm_tpu_torch/core/csrc/hist_part.cu``, each
the source with a few exact text substitutions (``VARIANTS``), into
``build/probe_part/`` with the port's nvcc flags, and times them in turns
(v1 .. vn, then vn .. v1, ``--rounds`` times) at chip_smoke.py's part
shapes (``chip_smoke.PART_SHAPES``: the layout of 1,000,000 rows at 255
leaves, Np = 1,525,760, F = 28, B = 255; A: S = 1, every row-holding
tile active; B: S = 16, all; C: S = 16, half; D: S = 16, an eighth) and
at shape C with skewed bins (80-98% of each feature's rows at bin 0):

- ``built``: the kernel as it is;
- ``float_count``: every row's count value is added with a shared f32
  compare-and-swap loop, as its other two values are, in place of the
  native integer add of a row whose count value is 1;
- ``lockstep``: every item walks the features from the first, so the
  lanes of a warp add into one feature at a time;
- ``stagger1``, ``stagger8``: each item, or each group of 8 neighbouring
  items, starts at a feature of its own, where the kernel starts groups
  of 4 there: the lanes of a warp add into 32 or 4 features at a time;
- ``fsplit_fill``: an item takes every feature unless the piece has
  fewer 4-row groups than the block has threads (fsplit = max(1,
  min(Ft, 1,024 / groups))), in place of ``pick_fsplit``'s balance of
  passes and features;
- ``no_add``: the add phase left out (the list, memset, zeroing, count
  folds and flushes alone);
- ``no_flush``: the flushes, which also zero the histogram, left out
  (the list, memset, first zeroing and adds alone).

The first six are held against the plain version (``chip_smoke.
check_part_result``); the last two compute no histogram. For each shape
and variant it prints the event time (median of 20 CUDA-event-timed calls,
L2 evicted) and the device time by launch (torch.profiler), then the
card's name and power limit and one JSON line. Needs a CUDA device and
nvcc; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

# (name, [(text of hist_part.cu, its replacement)]); each text must occur
# exactly once
VARIANTS = [
    ("built", []),
    ("float_count", [
        ("if (ms[q] == 1.f && (ls[q] == 0.f || ls[q] == 1.f)) "
         "counted |= 1u << q;", "if (false) counted |= 1u << q;")]),
    ("lockstep", [("int step = (q4 >> 2) % cnt;", "int step = 0;")]),
    ("stagger1", [("int step = (q4 >> 2) % cnt;", "int step = q4 % cnt;")]),
    ("stagger8", [("int step = (q4 >> 2) % cnt;",
                   "int step = (q4 >> 3) % cnt;")]),
    ("fsplit_fill", [("const int fsplit = pick_fsplit(groups, fw);",
                      "const int fsplit = max(1, min(fw, (int)blockDim.x "
                      "/ groups));")]),
    ("no_add", [("    add_piece(x, sel, vals, act_tile, sh + lead, counts,",
                 "    if (0) add_piece(x, sel, vals, act_tile, sh + lead, "
                 "counts,")]),
    ("no_flush", [("    flush_piece(sh4, groups4, lead, cells, out + dst);",
                   "    if (0) flush_piece(sh4, groups4, lead, cells, "
                   "out + dst);")]),
]
CHECKED = ("built", "float_count", "lockstep", "stagger1", "stagger8",
           "fsplit_fill")


def build_variants(root: str):
    """{variant: loaded ctypes library}, one nvcc per variant, all started
    together."""
    from lightgbm_tpu_torch import device
    src = open(os.path.join(root, "lightgbm_tpu_torch", "core", "csrc",
                            "hist_part.cu")).read()
    out_dir = os.path.join(root, "build", "probe_part")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS:
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError("variant %s: %r occurs %d times in "
                                     "hist_part.cu" % (name, old,
                                                       text.count(old)))
            text = text.replace(old, new)
        cu = os.path.join(out_dir, "%s.cu" % name)
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, "lib%s.so" % name)
        procs[name] = (subprocess.Popen(
            [device._nvcc(), *device.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed on variant %s:\n%s"
                               % (name, log))
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_part_kernel: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightgbm_tpu_torch.core import kernels

    libs = build_variants(root)
    real = kernels._part_lib()
    for lib in libs.values():
        for fn in ("lgbt_hist_part_launch", "lgbt_part_error_string"):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
    dev = torch.device("cuda", 0)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)
    b = 255
    shapes = [(label, s, share, False) for label, s, share in cs.PART_SHAPES]
    shapes.append(("C-skewed", 16, 0.5, True))
    results = []
    for label, s, share, skewed in shapes:
        inputs, tile = cs.part_inputs(dev, s, share)
        if skewed:
            r = np.random.RandomState(5)
            xb = inputs[0]
            f = xb.shape[0]
            for k in range(f):
                hit = torch.as_tensor(r.rand(xb.shape[1])
                                      < 0.8 + 0.18 * k / f, device=dev)
                xb[k].masked_fill_(hit, 0)
        want = cs.part_plain(inputs, b, s, tile)
        absum = cs.part_plain(inputs, b, s, tile, inputs[2].abs())
        calls = {}
        for name, lib in libs.items():
            def call(lib=lib):
                saved = kernels._part_lib
                kernels._part_lib = lambda: lib
                try:
                    return cs.part_call(kernels, inputs, b, s, tile)
                finally:
                    kernels._part_lib = saved
            if name in CHECKED:
                cs.check_part_result(call(), want, absum, inputs[3], s)
            calls[name] = call
        torch.cuda.synchronize()
        taken = {name: {"ms": [], "split": []} for name in calls}
        order = list(calls)
        for i in range(2 * args.rounds):
            for name in (order if i % 2 == 0 else order[::-1]):
                taken[name]["ms"].append(cs.time_ms(calls[name], flush))
                taken[name]["split"].append(cs.device_split(calls[name],
                                                            flush))
        row = {"shape": label, "S": s, "share": share, "skewed": skewed}
        for name, t in taken.items():
            splits = [d for d in t["split"] if d is not None]
            keys = sorted({k for d in splits for k in d})
            split = ({k: statistics.median(d.get(k, 0.0) for d in splits)
                      for k in keys} if splits else None)
            row[name] = {"ms": statistics.median(t["ms"]), "turns": t["ms"],
                         "device_split": split}
            print("part %s %s: event %.4f ms (turns %s), device %s ms (%s)"
                  % (label, name, row[name]["ms"],
                     " ".join("%.4f" % x for x in t["ms"]),
                     cs.fmt(None if split is None else sum(split.values())),
                     cs.fmt_split(split)), flush=True)
        results.append(row)
        del inputs, want, absum, calls
    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "shapes": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
