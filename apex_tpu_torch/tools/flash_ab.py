"""Device time of the flash-attention kernels of two checkouts, in turns.

    python3 apex_tpu_torch/tools/flash_ab.py TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory) is timed in its own
process, with its own ``apex_tpu_torch`` and its own kernel build, in the
order given, so ``parent . . parent`` compares two commits on one card.
Each prints one JSON line: CUDA-event ms per call (after a warm-up) of
the forward, the partials backward and, where the tree has them, the
dq-accumulating backward and the forward with ``probs_bf16``, all bf16
with dropout 0.1, at GPT-2 small's causal shape (16 x 12 x 1024, head_dim
64), GPT-2 medium's (8 x 16 x 1024, with ``probs_bf16`` as its path runs
it), BERT-large's with a key-padding bias (12 x 16 x 512) and a causal
head_dim-128 shape (16 x 8 x 1024); a shape a tree's kernels do not take
reads as the error it raised.  The first line is the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def _events_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_tree() -> dict:
    """The timings of the ``apex_tpu_torch`` in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import attention as A

    _build.build(["flash_attention"])
    dev = "cuda"
    out = {"tree": os.getcwd()}
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, b, h, s, d, causal, padded, probs in (
            ("gpt2_small", 16, 12, 1024, 64, True, False, False),
            ("gpt2_medium", 8, 16, 1024, 64, True, False, True),
            ("bert_large", 12, 16, 512, 64, False, True, False),
            ("d128", 16, 8, 1024, 128, True, False, False)):
        bh = b * h
        q = (2 * torch.randn(bh, s, d, device=dev, generator=gen)).bfloat16()
        k, v, do = (torch.randn(bh, s, d, device=dev,
                                generator=gen).bfloat16() for _ in range(3))
        bias = None
        if padded:
            bias = torch.zeros(b, 1, s, device=dev)
            bias[:, :, 400:] = -1e9
            bias = bias.expand(b, s, s)
        args = (A._pack_seed(5, device=dev), d ** -0.5, causal, 0.1, (h, h))
        kw = {"bias": bias}
        if probs:
            kw["probs_bf16"] = True
        try:
            o, lse = A.flash_attention_fwd(q, k, v, *args, **kw)
        except ValueError as e:
            out[name] = f"not taken: {e}"
            continue
        out[name + "_fwd"] = _events_ms(
            lambda: A.flash_attention_fwd(q, k, v, *args, **kw), 20)
        out[name + "_bwd"] = _events_ms(
            lambda: A.flash_attention_bwd(q, k, v, o, lse, do, *args,
                                          **kw), 10)
        if hasattr(A, "flash_attention_bwd_acc"):
            out[name + "_bwd_acc"] = _events_ms(
                lambda: A.flash_attention_bwd_acc(q, k, v, o, lse, do, *args,
                                                  **kw), 10)
            if not probs:
                out[name + "_fwd_probs_bf16"] = _events_ms(
                    lambda: A.flash_attention_fwd(q, k, v, *args, bias=bias,
                                                  probs_bf16=True), 20)
    return out


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if trees == ["--here"]:
        print(json.dumps(time_tree()), flush=True)
        return 0
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    print(smi.stdout.strip(), flush=True)
    script = os.path.abspath(__file__)
    for tree in trees:
        subprocess.run([sys.executable, script, "--here"],
                       cwd=os.path.abspath(tree), check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
