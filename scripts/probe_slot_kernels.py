"""Probes of the slot histogram kernels' plan choices on one card.

    python3 scripts/probe_slot_kernels.py

At chip_smoke.py's slot shapes (``chip_smoke.SLOT_SHAPES``: 1,000,000 x
28 rows of 255 bins, half of them active; K=3 at S = 2, 16, 128, 254 and
K=6 at S = 16) it measures ``hist_slots.cu`` under the plan constants of
``core/kernels.py`` it varies, in turns (A B B A), each with the event
time (median of 20 CUDA-event-timed calls, L2 evicted) and the device
time by launch (torch.profiler):

1. replicas: SLOT_MAX_REPLICAS 1 and 2 (K=6 fits one), with the bins as
   drawn (uniform) and with 80% or 98% of every feature's bins set to 0,
   as a sparse feature has them. Every result, and the plain f32
   version's, is held against the plain version in float64: the largest
   |difference| / sum|v| of a cell and the cells past the 1e-5 * sum|v|
   + 1e-6 tolerance;
2. sort rows: SLOT_SORT_ROWS at 1,024, 2,048 and 8,192, uniform bins;
3. large S: K=3 at S = 1,023 and 4,095 with the plan as it is, beside
   one ``index_add_`` (``chip_smoke.slot_library``) and the bound.

Prints one line per measurement and the card's name and power limit.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def plan_constants(kernels, **values):
    """Set module constants of ``kernels`` that the slot plan reads, and
    restore them after."""
    saved = {name: getattr(kernels, name) for name in values}
    try:
        for name, value in values.items():
            setattr(kernels, name, value)
        kernels.slot_hist_launch_plan.cache_clear()
        yield
    finally:
        for name, value in saved.items():
            setattr(kernels, name, value)
        kernels.slot_hist_launch_plan.cache_clear()


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("probe_slot_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from lightgbm_tpu_torch.core import kernels

    dev = torch.device("cuda", 0)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev)

    def measure(call):
        split = cs.device_split(call, flush)
        return "event %.4f ms, device %s ms (%s)" % (
            cs.time_ms(call, flush),
            cs.fmt(None if split is None else sum(split.values())),
            cs.fmt_split(split))

    for zero_share in (0.0, 0.8, 0.98):
        for n, f, b, k, s in cs.SLOT_SHAPES:
            xb, slot, v, sel = cs.slot_inputs(dev, n, f, b, k, s)
            if zero_share:
                g = torch.Generator(device=dev).manual_seed(5)
                xb = torch.where(torch.rand(xb.shape, device=dev,
                                            generator=g) < zero_share,
                                 torch.zeros_like(xb), xb).contiguous()
            ref = cs.slot_plain(xb, slot, v.double(), sel.double(), b, s, k)
            absum = cs.slot_plain(xb, slot, v.double().abs(), sel.double(),
                                  b, s, k)
            tol = cs.HIST_REL_TOL * absum + cs.HIST_ABS_TOL

            def against_f64(got):
                d = (got.double() - ref).abs()
                return "%.3g, %d cells past" % (
                    float((d / absum.clamp_min(1e-30)).max()),
                    int((d > tol).sum()))
            plain = against_f64(cs.slot_plain(xb, slot, v, sel, b, s, k))

            def call():
                return cs.slot_call(kernels, xb, slot, v, sel, b, s, k)
            for replicas in ((1,) if k == 6 else (1, 2, 2, 1)):
                with plan_constants(kernels, SLOT_MAX_REPLICAS=replicas):
                    print("replicas %d, %.0f%% of bins at 0, K=%d S=%d: "
                          "against float64 kernel %s, plain f32 %s; %s"
                          % (replicas, 100 * zero_share, k, s,
                             against_f64(call()), plain, measure(call)),
                          flush=True)
            if zero_share == 0.0:
                for rows in (1024, 2048, 8192, 8192, 2048, 1024):
                    with plan_constants(kernels, SLOT_SORT_ROWS=rows):
                        print("sort rows %d, K=%d S=%d: %s"
                              % (rows, k, s, measure(call)), flush=True)
            del xb, slot, v, sel, ref, absum, tol
    for s in (1023, 4095):
        n, f, b, k = 1_000_000, 28, 255, 3
        xb, slot, v, sel = cs.slot_inputs(dev, n, f, b, k, s)

        def call():
            return cs.slot_call(kernels, xb, slot, v, sel, b, s, k)
        cs.check_slot_result(call(), cs.slot_plain(xb, slot, v, sel, b, s, k),
                             cs.slot_plain(xb, slot, v.abs(), sel, b, s, k),
                             s, k)
        library, n_active = cs.slot_library(xb, slot, v, sel, b, s, k)
        bound_ms, bound_by = cs.bound(
            kernels.slot_hist_bytes(n, n_active, f, b, k, s),
            n_active * f * k)
        print("large S, K=3 S=%d: %s; index_add_ %.4f ms; bound %.4f ms "
              "(%s)" % (s, measure(call), cs.time_ms(library, flush),
                        bound_ms, bound_by), flush=True)
        del xb, slot, v, sel, library
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
