"""Which collectives gloo takes on CUDA tensors, on this machine.

    python3 -m apex_tpu_torch.tools.gloo_cuda_probe

Two gloo ranks share the first card and try each collective once on
small CUDA tensors, checking the values; one JSON line reports, for each,
``ok``, ``wrong`` (it ran but the values are wrong) or the error.  The
point-to-point pair (``isend``/``irecv``) runs in a gang of its own, last,
so that a rank that dies there costs only that entry.
``apex_tpu_torch.parallel.mesh.GLOO_CUDA`` lists what the port hands to
gloo on CUDA tensors; everything else goes through host memory.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.multiproc import init_distributed, launch

COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "all_gather")


def _try(name: str, r: int, dev) -> str:
    x = torch.full((4,), float(r + 1), device=dev)
    if name == "all_reduce":
        dist.all_reduce(x)
        want = torch.full((4,), 3.0, device=dev)
    elif name == "broadcast":
        dist.broadcast(x, 0)
        want = torch.ones(4, device=dev)
    elif name == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, torch.tensor([1.0] * 4 + [2.0] * 4, device=dev)
    elif name == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        x, want = out, torch.full((2,), 3.0, device=dev)
    elif name == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x)
        x, want = out, torch.tensor([1.0, 1.0, 2.0, 2.0], device=dev)
    elif name == "all_gather":
        outs = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(outs, x)
        x = torch.cat(outs)
        want = torch.tensor([1.0] * 4 + [2.0] * 4, device=dev)
    else:  # isend/irecv: rank 0 sends its tensor to rank 1
        if r == 0:
            dist.isend(x, 1).wait()
            return "ok"
        dist.irecv(x, 0).wait()
        want = torch.ones(4, device=dev)
    torch.cuda.synchronize()
    return "ok" if torch.equal(x, want) else "wrong"


def _worker(out_dir: str, names) -> int:
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=60)
    r = dist.get_rank()
    dev = torch.device("cuda", 0)
    res = {}
    for name in names:
        try:
            res[name] = _try(name, r, dev)
        except Exception as err:  # the probe's finding, not a failure
            res[name] = f"raises {type(err).__name__}: {str(err)[:160]}"
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()
    return 0


def _gang(names) -> dict:
    out_dir = tempfile.mkdtemp(prefix="apex_gloo_probe_")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    results = launch([os.path.abspath(__file__), "--worker", out_dir,
                      ",".join(names)], 2, env=env, timeout_s=120,
                     echo_stderr=False)
    path = os.path.join(out_dir, "rank1.json")
    got = json.load(open(path)) if os.path.exists(path) else {}
    for name in names:
        if name not in got:
            got[name] = f"a rank died (exit codes " \
                        f"{[w.returncode for w in results]})"
    return got


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], argv[2].split(","))
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    res = _gang(COLLECTIVES)
    res.update(_gang(("isend_irecv",)))
    print(json.dumps({"gloo_on_cuda_tensors": res,
                      "torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
