#!/usr/bin/env python3
"""Times of the battery kernels (histogram, GF(2) rank) and the mwc
generator's kernel of one source tree on one NVIDIA GPU, to compare two
commits in one run.

    python3 chip_kernel_times.py SRC OUT.json

SRC is the ``src`` directory of a checkout: this one's, or that of
another commit unpacked from ``git archive`` into an ignored directory.
The script imports ``repro_torch`` from SRC only, builds that tree's
kernels, and runs ``chip_smoke.py``'s own cases on them (``hist_case``,
``rank_case``, ``mwc_case``: checked against the plain version, bitwise,
then per-call and device times). The shapes are the parity shapes (for
mwc, 2^23 words) and the main-path shapes that ``chip_smoke.py``
recorded in ``reports/chip_smoke/chip_smoke.json`` (for mwc, the
BigCrush buckets of its BigCrush x1.0 run), so run that first. Prints
what CUDA events read around an empty call and the device time of an
empty launch, one line per shape and the main-path totals (each shape's
time times its launches), and writes every case to OUT.json.

To compare a parent P with this tree on the same card, in one call:
run P, this, this, P.
"""
import json
import os
import sys

import chip_smoke as cs

FIELDS = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src, out_path = (os.path.abspath(a) for a in argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p) != os.path.join(cs.ROOT, "src")]
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    cs.check(os.path.dirname(build.__file__).startswith(src),
             f"repro_torch was not imported from {src}")
    build.build(["histogram", "gf2_rank", "mwc"])
    with open(os.path.join(cs.OUT_DIR, "chip_smoke.json")) as f:
        main_shapes = json.load(f)["main_path_shapes"]
    # what CUDA events read around a call that launches nothing
    floor = cs.median_ms(lambda: None)
    empty = cs.device_ms(lambda: torch.cuda._sleep(0))
    print(f"[floor] empty call between two CUDA events: {floor:.4f} ms; "
          f"empty launch on the device: {empty:.4f} ms", flush=True)
    result = {"src": src, "card": torch.cuda.get_device_name(0),
              "event_floor_ms": floor, "empty_launch_device_ms": empty,
              "histogram": {"parity": [], "main": []},
              "gf2_rank": {"parity": [], "main": []},
              "mwc": {"parity": [], "main": []}}

    def mwc_case(n, seed=0):
        return cs.mwc_case(n, [cs.mwc_state(7, seed)])
    cases = {"histogram": (cs.hist_case, lambda c: (c["n"], c["nbins"]),
                           cs.HIST_PARITY),
             "gf2_rank": (cs.rank_case, lambda c: (c["m"],),
                          [(m,) for m in cs.RANK_PARITY]),
             "mwc": (mwc_case, lambda c: (c["n"],), [(1 << 23,)])}
    for name, (case, shape, parity) in cases.items():
        for args in parity:
            c = case(*args)
            result[name]["parity"].append(c)
            cs.print_battery(name, c)
        for m in main_shapes[name]:
            c = case(*shape(m), seed=1) | {"launches": m["launches"]}
            result[name]["main"].append(c)
            cs.print_battery(name, c)
        rows = result[name]["main"]
        launches = sum(c["launches"] for c in rows)
        totals = {k: sum(c[k] * c["launches"] for c in rows)
                  for k in FIELDS if all(c[k] is not None for c in rows)}
        result[name]["main_total"] = {"launches": launches, **totals}
        print(f"[total] {name} main path, {launches} launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in totals.items())
              + f" | per call {totals['ms'] / launches:.4f} ms, device "
              f"{totals['device_ms'] / launches:.4f} ms", flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
