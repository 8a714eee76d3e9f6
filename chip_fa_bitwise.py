#!/usr/bin/env python3
"""The flash-attention kernel of two source trees on one NVIDIA GPU, held
to each other bit for bit.

    python3 chip_fa_bitwise.py SRC_A SRC_B [OUT.json]

SRC_A and SRC_B are ``src`` directories of two checkouts: this one's, and
that of another commit unpacked from ``git archive`` into an ignored
directory. Each tree runs in a process of its own, which imports
``repro_torch`` from that tree only, builds its flash-attention library,
and calls ``ops.mha`` with the arguments every tree since the sliding
window takes (``scale``, ``softcap``, ``window``) on the same seeded
inputs: qwen2-1.5b's serving shapes on both routes (bfloat16 on
``wgmma``, float32 on ``simt``), a padded prompt, a window with a
softcap on both routes, head dim 192, a v head dim of its own, and
whisper's non-causal encoder on both routes (``causal=False``, a tree
since the key count takes it). Each case runs twice in each tree: the
serving call, and the call with q, k and v requiring grad, which a tree
with the backward sends through its autograd path (the forward with the
row log-sum-exp on); a tree without it makes the serving call again.
Every output of one tree is compared with the other tree's serving
output with ``torch.equal``; any difference fails. Writes each case's
verdict to OUT.json when given.
"""
import json
import os
import subprocess
import sys
import tempfile

# (B, S, H, K, dh, dv, softcap, window, dtype, causal)
CASES = [(4, 512, 12, 2, 128, 128, 0.0, 0, "bfloat16", True),  # qwen2-1.5b
         (2, 2048, 12, 2, 128, 128, 0.0, 0, "bfloat16", True),
         (4, 512, 12, 2, 128, 128, 0.0, 0, "float32", True),
         (2, 2048, 12, 2, 128, 128, 0.0, 0, "float32", True),
         (1, 200, 12, 2, 128, 128, 0.0, 0, "bfloat16", True),   # padded
         (1, 1024, 4, 2, 128, 128, 50.0, 300, "bfloat16", True),  # window
         (1, 1024, 4, 2, 64, 64, 50.0, 300, "float32", True),
         (1, 512, 8, 8, 192, 192, 0.0, 0, "bfloat16", True),    # dh 192
         (1, 512, 8, 8, 192, 128, 0.0, 0, "float32", True),     # dv 128
         (2, 1500, 12, 12, 64, 64, 0.0, 0, "bfloat16", False),  # whisper
         (2, 1500, 12, 12, 64, 64, 0.0, 0, "float32", False)]   # encoder


def dump(src, path):
    """In this process: the outputs of every case from tree ``src``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.ops import mha
    if not os.path.dirname(build.__file__).startswith(src):
        raise RuntimeError(f"repro_torch was not imported from {src}")
    outs = []
    for i, (b, s, h, kh, dh, dv, cap, window, dtype, causal) in enumerate(
            CASES):
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda")
                   .to(dt) for n, d in ((h, dh), (kh, dh), (kh, dv)))
        kw = {"scale": dh ** -0.5, "softcap": cap, "window": window}
        if not causal:
            kw["causal"] = False
        serve = mha(q, k, v, **kw)
        grad = mha(*(x.requires_grad_(True) for x in (q, k, v)), **kw)
        torch.cuda.synchronize()
        outs.append((serve.cpu(), grad.detach().cpu()))
    torch.save(outs, path)


def main(argv):
    if len(argv) == 3 and argv[0] == "--dump":
        dump(os.path.abspath(argv[1]), argv[2])
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_fa_bitwise: no CUDA device", file=sys.stderr)
        return 1
    srcs = [os.path.abspath(a) for a in argv[:2]]
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, src in enumerate(srcs):
            path = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--dump", src, path], check=True, timeout=900)
            outs.append(torch.load(path))
    rows, same = [], True
    for case, (a, a_grad), (b, b_grad) in zip(CASES, *outs):
        pairs = {"serving": (a, b), "A with grad": (a_grad, b),
                 "B with grad": (b_grad, a)}
        verdict = {name: torch.equal(x, y) for name, (x, y) in pairs.items()}
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in pairs.values())
        equal = all(verdict.values())
        same &= equal
        rows.append({"case": case, "bitwise": equal, "by_call": verdict,
                     "max_abs_diff": err})
        print(f"[fa bitwise] B{case[0]} S{case[1]} H{case[2]} K{case[3]} "
              f"dh{case[4]} dv{case[5]} cap{case[6]} window {case[7]} "
              f"{case[8]} {'causal' if case[9] else 'non-causal'}: "
              f"{'bitwise equal' if equal else 'DIFFERENT'} "
              f"(serving, and each tree's call with grad against the other's "
              f"serving call: {verdict}; max |diff| {err:.3g})", flush=True)
    if len(argv) == 3:
        with open(argv[2], "w") as f:
            json.dump({"srcs": srcs, "card": torch.cuda.get_device_name(0),
                       "cases": rows}, f, indent=1)
    print(f"[fa bitwise] {srcs[0]} vs {srcs[1]}: "
          + ("every case bitwise equal" if same else "outputs differ"),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
