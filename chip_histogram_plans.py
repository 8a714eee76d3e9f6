#!/usr/bin/env python3
"""Device times of the histogram kernel under the launch plan that
``kernels/histogram/kernel.py::plan`` picks and under variants of it, at
the shapes where the plan's constants were chosen, on one NVIDIA GPU.

    python3 chip_histogram_plans.py OUT.json

Each variant (another cluster size, grid, copy count, slice or route)
is the plan that ``plan`` makes with those keyword overrides, launched
through ``kernel._launch`` (uncounted), checked against the plain
version, bitwise, and timed with ``chip_smoke.device_ms``. Prints one
line per variant and writes them all to OUT.json.
"""
import dataclasses
import json
import sys

import chip_smoke as cs

# (N, nbins, variants): each variant is keyword overrides of ``plan``
CASES = [
    (1 << 26, 4, [{}, dict(cluster=8), dict(cluster=8, blocks=136)]),
    (1 << 24, 22, [{}, dict(cluster=8)]),
    (1 << 24, 4096, [{}, dict(warp_copies=1), dict(cluster=8)]),
    (1 << 24, 57344, [{}, dict(cluster=8)]),
    (1 << 17, 16384, [{}, dict(cluster=2)]),
    (1 << 26, 65536, [{}, dict(slice_log2=14, blocks=132),
                      dict(slice_log2=13, blocks=128), dict(route="global")]),
    (1 << 24, 1 << 17, [{}, dict(route="global")]),
    (1 << 24, 1 << 18, [{}, dict(route="split", blocks=128)]),
    (1 << 26, 1 << 20, [{}, dict(blocks=264)]),
]


def main(argv):
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_histogram_plans: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.histogram import kernel as hk
    from repro_torch.kernels.histogram.ref import histogram_ref
    limits = hk.device_limits(0)
    rows = []
    for n, k, variants in CASES:
        g = torch.Generator(device="cuda").manual_seed(n + k)
        idx = torch.randint(0, k, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
        want = histogram_ref(idx, k)
        for kw in variants:
            pl = hk.plan(n, k, *limits, **kw)
            got = hk._launch(idx, k, pl)
            torch.cuda.synchronize()
            cs.check(torch.equal(got, want), f"N={n} k={k} {pl}: != plain")
            ms = cs.device_ms(lambda: hk._launch(idx, k, pl))
            rows.append({"n": n, "nbins": k, "variant": kw or "chosen",
                         "plan": dataclasses.asdict(pl), "device_ms": ms})
            print(f"[plan] N={n} k={k} {kw or 'chosen'}: device {ms:.4f} ms "
                  f"| {pl}", flush=True)
    with open(argv[0], "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0), "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
