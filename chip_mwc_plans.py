#!/usr/bin/env python3
"""Device times of the mwc kernel under the launch plan that
``kernels/mwc/kernel.py::plan`` picks and under other splits of the same
words (chunk, threads), at BigCrush's lengths and at 2^23, on one NVIDIA
GPU.

    python3 chip_mwc_plans.py OUT.json

Each variant is the plan that ``plan`` makes with those keyword
overrides, launched through ``kernel._launch`` (uncounted), checked
against the plain loop, bitwise, and timed with ``chip_smoke.device_ms``;
an empty launch (``torch.cuda._sleep(0)``) is timed the same way. Prints
one line per variant and writes them all to OUT.json.
"""
import json
import sys

import chip_smoke as cs

# n, then (chunk, threads) overrides beside the chosen plan
LENGTHS = [1 << e for e in (10, 12, 14, 15, 16, 17, 18, 19, 20, 23)]
VARIANTS = [(1, 32), (1, 64), (2, 64), (4, 32), (4, 64), (4, 128), (8, 64),
            (8, 128), (16, 32), (16, 64), (16, 128), (32, 128), (64, 128)]


def main(argv):
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_mwc_plans: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.mwc import kernel as mk
    from repro_torch.kernels.mwc.ref import mwc_ref
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = mk.sm_count(dev.index)
    x0, c0 = cs.mwc_state(7, 0)
    want = mwc_ref(x0, c0, max(LENGTHS), "cpu").to(dev)
    empty = cs.device_ms(lambda: torch.cuda._sleep(0))
    print(f"[plan] empty launch: device {empty:.4f} ms", flush=True)
    rows = [{"empty_launch_device_ms": empty,
             "card": torch.cuda.get_device_name(0), "sms": sms}]
    for n in LENGTHS:
        chosen = mk.plan(n, sms)
        plans = [chosen] + [p for p in (mk.plan(n, sms, chunk=c, threads=t)
                                        for c, t in VARIANTS)
                            if p != chosen]
        for pl in plans:
            got = mk._launch(x0, c0, n, pl, dev, dev.index)
            cs.check(torch.equal(got, want[:n]), f"n={n} {pl}: != plain")
            ms = cs.device_ms(lambda: mk._launch(x0, c0, n, pl, dev,
                                                 dev.index))
            bound, _ = cs.bound_ms(8 * n, 2 * n, cs.INT32_OPS_PER_S)
            rows.append({"n": n, "plan": pl._asdict(),
                         "chosen": pl == chosen, "device_ms": ms,
                         "bound_ms": bound})
            print(f"[plan] n={n} chunk={pl.chunk} threads={pl.threads} "
                  f"blocks={pl.blocks}{' (chosen)' if pl == chosen else ''}"
                  f": device {ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    with open(argv[0], "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
