"""Which collectives gloo takes on CUDA tensors, by op and dtype.

    python3 -m apex_tpu_torch.tools.gloo_cuda_probe

Two gloo ranks share the first card and try each (collective, dtype)
pair of :data:`CASES` once on small CUDA tensors, checking the values
(small integers, exact in every dtype); one JSON line reports, for each
``"<op>:<dtype>"``, ``ok``, ``wrong`` (it ran but the values are wrong)
or the error.  The point-to-point pair (``isend``/``irecv``) runs in a
gang of its own, last, so that a rank that dies there costs only that
entry.  ``apex_tpu_torch.parallel.mesh.GLOO_CUDA`` lists the (op, dtype)
pairs the port hands to gloo on CUDA tensors; every other goes through
host memory.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel.multiproc import init_distributed, launch

_F32, _BF16, _I8 = "float32", "bfloat16", "int8"
#: (op, dtype) pairs, the op named as ``GLOO_CUDA`` names it
#: (``all_reduce_max``: a MAX all-reduce; ``all_gather_list``: the list
#: form of ``all_gather``, which the port does not use)
CASES = (
    ("all_reduce", _F32), ("all_reduce", _BF16), ("all_reduce", _I8),
    ("all_reduce_max", _F32),
    ("reduce_scatter", _F32), ("reduce_scatter", _BF16),
    ("reduce_scatter", _I8),
    ("all_gather", _F32), ("all_gather", _BF16), ("all_gather", _I8),
    ("all_to_all", _F32), ("all_to_all", _BF16),
    ("broadcast", _F32), ("all_gather_list", _F32),
)


def _try(op: str, dtype: str, r: int, dev) -> str:
    dt = getattr(torch, dtype)
    full = lambda n, v: torch.full((n,), v, dtype=dt, device=dev)  # noqa
    cat = lambda *p: torch.cat([full(n, v) for n, v in p])  # noqa: E731
    x = full(4, r + 1)
    if op == "all_reduce":
        dist.all_reduce(x)
        want = full(4, 3)
    elif op == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        want = full(4, 2)
    elif op == "broadcast":
        dist.broadcast(x, 0)
        want = full(4, 1)
    elif op == "all_gather":
        out = torch.empty(8, dtype=dt, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, cat((4, 1), (4, 2))
    elif op == "reduce_scatter":
        out = torch.empty(2, dtype=dt, device=dev)
        dist.reduce_scatter_tensor(out, x)
        x, want = out, full(2, 3)
    elif op == "all_to_all":
        out = torch.empty(4, dtype=dt, device=dev)
        dist.all_to_all_single(out, x)
        x, want = out, cat((2, 1), (2, 2))
    elif op == "all_gather_list":
        outs = [torch.empty(4, dtype=dt, device=dev) for _ in range(2)]
        dist.all_gather(outs, x)
        x, want = torch.cat(outs), cat((4, 1), (4, 2))
    else:  # isend/irecv: rank 0 sends its tensor to rank 1
        if r == 0:
            dist.isend(x, 1).wait()
            return "ok"
        dist.irecv(x, 0).wait()
        want = full(4, 1)
    torch.cuda.synchronize()
    return "ok" if torch.equal(x, want) else "wrong"


def _worker(out_dir: str, names) -> int:
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=60)
    r = dist.get_rank()
    dev = torch.device("cuda", 0)
    res = {}
    for name in names:
        op, dtype = name.split(":")
        try:
            res[name] = _try(op, dtype, r, dev)
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


def probe() -> dict:
    """``{"<op>:<dtype>": result}`` for every case and the p2p pair."""
    res = _gang([f"{op}:{dt}" for op, dt in CASES])
    res.update(_gang(("isend_irecv:float32",)))
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        return _worker(argv[1], argv[2].split(","))
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps({"gloo_on_cuda_tensors": probe(),
                      "torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
