"""Which collectives gloo takes on CUDA tensors, and whether NCCL takes two
ranks on one card.

`parallel.collectives.HOST_STAGED` routes the collectives gloo refuses on
CUDA tensors through pinned host buffers; this script is where that
table's gloo rows come from. For each of the five ops of
`collectives.OPS`, two ranks on card 0 join a gloo group and run the op
once on CUDA tensors, called on `torch.distributed` directly (not
through the routing), with its result held against the expected values.
Each op has processes of its own: gloo aborts the process (an uncaught
`gloo::IoException`, "Bad address") when it writes from a device
pointer, so an op that does not take CUDA tensors ends its ranks.
Then two ranks on card 0 try an NCCL all-reduce, which NCCL is expected
to refuse (a duplicate GPU). One JSON line each; run on a machine with a card:

    python -m deeplearning4j_tpu_torch.benchmarks.gloo_probe
"""
from __future__ import annotations

import json
import sys


def _probe_rank(op: str) -> dict:
    import torch
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.multihost import rank_device
    dev = rank_device()
    r, n = dist.get_rank(), dist.get_world_size()
    x = (torch.arange(8, dtype=torch.float32, device=dev) + 10 * r)
    base = torch.arange(8, dtype=torch.float32, device=dev)
    allx = [base + 10 * j for j in range(n)]

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, sum(allx)

    def all_gather():
        y = torch.empty(8 * n, device=dev)
        dist.all_gather_into_tensor(y, x)
        return y, torch.cat(allx)

    def reduce_scatter():
        y = torch.empty(8 // n, device=dev)
        dist.reduce_scatter_tensor(y, x)
        return y, sum(allx).chunk(n)[r]

    def all_to_all():
        y = torch.empty(8, device=dev)
        dist.all_to_all_single(y, x)
        return y, torch.cat([a.chunk(n)[r] for a in allx])

    def send_recv():
        y = torch.empty(8, device=dev)
        ops = [dist.P2POp(dist.isend, x, (r + 1) % n),
               dist.P2POp(dist.irecv, y, (r - 1) % n)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return y, allx[(r - 1) % n]

    fn = locals()[op]
    try:
        got, want = fn()
        torch.cuda.synchronize()
        out = ("accepts" if torch.equal(got.cpu(), want.cpu())
               else "wrong result")
    except Exception as e:      # the probe records refusals
        out = "raises: " + str(e).splitlines()[0][:160]
    return {"rank": r, "backend": dist.get_backend(), "device": str(dev),
            "torch": torch.__version__, "op": op, "outcome": out}


def _nccl_rank() -> dict:
    import torch
    import torch.distributed as dist
    y = torch.ones(4, device="cuda")
    dist.all_reduce(y)
    torch.cuda.synchronize()
    return {"sum": float(y[0])}


def main() -> int:
    from deeplearning4j_tpu_torch.parallel.collectives import OPS
    from deeplearning4j_tpu_torch.parallel.multihost import MultiHostLauncher
    for op in OPS:
        try:
            res = MultiHostLauncher(2, device="cuda", backend="gloo").run(
                _probe_rank, timeout=120, args=(op,))
            outcome = sorted({r["outcome"] for r in res})
        except RuntimeError as e:   # the op ended its ranks
            outcome = ["aborts: " + " | ".join(
                ln.strip() for ln in str(e).splitlines()
                if "what()" in ln or "Exception" in ln)[:300]]
        print(json.dumps({"probe": "gloo_cuda", "op": op,
                          "outcome": outcome}), flush=True)
    try:
        got = MultiHostLauncher(2, device="cuda", backend="nccl").run(
            _nccl_rank, timeout=120)
        nccl = {"outcome": "accepted", "ranks": got}
    except RuntimeError as e:       # the expected refusal
        text = str(e)
        key = [ln for ln in text.splitlines()
               if "uplicate" in ln or "Error" in ln][:4]
        nccl = {"outcome": "refused", "lines": key}
    print(json.dumps({"probe": "nccl_two_ranks_one_card", **nccl}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
