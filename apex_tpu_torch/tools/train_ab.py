"""End-to-end training throughput of two checkouts on one card, in turns.

    python3 apex_tpu_torch/tools/train_ab.py [--only RUN[,RUN]] TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory) runs in its own
process, with its own ``apex_tpu_torch``, kernel build and
``chip_smoke.py``, that script's three transformer training phases, each
followed by its one-step profile: GPT-2 small O2 (``phase_train``),
BERT-large MLM O2 with ``fused_lamb`` (``phase_bert_train``) and GPT-2
medium O2 with four microbatches a step (``phase_medium_train``), at the
script's own sizes, seeds and checks.  Trees run in the order given, so
``parent . . parent`` compares two commits on one card.  Each tree prints
one JSON line: tokens/s (sequences/s and valid tokens/s for BERT), peak
memory, and each profiled step's wall, device-busy time and share.  The
first line is the card's name and power limit.  ``--only`` keeps the
named runs (``gpt2_small``, ``bert_large``, ``gpt2_medium``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_KEYS = ("tokens_per_s", "sequences_per_s", "valid_tokens_per_s",
         "max_memory_allocated_bytes", "unprofiled_wall_ms",
         "device_busy_ms", "device_busy_share_unprofiled")


def time_tree(only=None) -> dict:
    """The training phases of the checkout in the working directory (those
    named in ``only``, or all)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as C

    lines = []
    C.emit = lines.append
    C.fp32_precision()
    dev = torch.device("cuda")
    C._build.build()
    runs = (
        ("gpt2_small", C.GPTConfig.small, C.init_params, 0,
         C.phase_train, "train_profile"),
        ("bert_large", C.BertConfig.large, C.init_bert_params, 20,
         C.phase_bert_train, "bert_profile"),
        ("gpt2_medium", C.GPTConfig.medium, C.init_params, 30,
         C.phase_medium_train, "medium_profile"))
    for name, cfg, init, seed, phase, profile in runs:
        if only and name not in only:
            continue
        params = init(cfg(), torch.Generator().manual_seed(seed))
        _, step, carry = phase(dev, params)[:3]
        C.phase_step_profile(step, carry, profile, name)
        del step, carry, params
        torch.cuda.empty_cache()
    out = {"tree": os.getcwd()}
    for rec in lines:
        phase = rec.get("phase", "")
        if phase.endswith("train") or phase.endswith("profile"):
            out[phase] = {k: rec[k] for k in _KEYS if k in rec}
    return out


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    only = []
    if trees[:1] == ["--only"] and len(trees) > 1:
        only, trees = ["--only", trees[1]], trees[2:]
    if trees == ["--here"]:
        print(json.dumps(time_tree(only[1].split(",") if only else None)),
              flush=True)
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
        subprocess.run([sys.executable, script, *only, "--here"],
                       cwd=os.path.abspath(tree), check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main())
