#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, on this machine's torch.

    python3 tools/gloo_cuda_probe.py

For each of ``all_gather``, ``broadcast``, ``batch_isend_irecv`` and
``send`` / ``recv``, starts two gloo ranks on ``cuda:0`` (through a
``file://`` store in a temporary directory) that run that op on CUDA
tensors and check the values they got.  A pair per op, because gloo may
abort the process (not raise) on a device pointer.  Prints one JSON line:
torch's version and, per op, ``ok``, ``wrong values``, the error raised, or
the ranks' exit codes.  The population mesh
(``repro_torch.distributed.sharding``) stages every gloo op through
page-locked host memory whatever this reports; the probe says which of
them would need it.
"""
import json
import os
import sys
import tempfile

OPS = ("all_gather", "broadcast", "batch_isend_irecv", "send_recv")


def _rank(rank, op, store, out):
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    y = torch.empty_like(x)
    if op == "all_gather":
        got = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(got, x)
        ok = all(torch.equal(g.cpu(), torch.arange(8.) + 10 * r) for r, g in enumerate(got))
    elif op == "broadcast":
        y.copy_(x)
        dist.broadcast(y, src=0)
        ok = torch.equal(y.cpu(), torch.arange(8.))
    elif op == "batch_isend_irecv":
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                           dist.P2POp(dist.irecv, y, 1 - rank)]):
            req.wait()
        ok = torch.equal(y.cpu(), torch.arange(8.) + 10 * (1 - rank))
    else:
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(y, 0)
        ok = rank == 0 or torch.equal(y.cpu(), torch.arange(8.))
    with open(f"{out}.{rank}", "w") as f:
        f.write("ok" if ok else "wrong values")
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("no CUDA device: the probe needs one", file=sys.stderr)
        return 1
    res = {"torch": torch.__version__}
    ctx = mp.get_context("spawn")
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out")
            procs = [ctx.Process(target=_rank, args=(r, op, os.path.join(tmp, "store"), out))
                     for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            said = [open(f"{out}.{r}").read() if os.path.exists(f"{out}.{r}") else None
                    for r in range(2)]
            res[op] = (said[0] if said[0] == said[1] and said[0] is not None else
                       f"ranks said {said}, exit codes {[p.exitcode for p in procs]}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
