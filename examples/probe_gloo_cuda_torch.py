"""Which gloo collectives take CUDA tensors: two processes on one GPU (the
layout of ``chip_smoke.py``'s world-size-2 config-4 run, where NCCL cannot
be used because it allows one rank a GPU) each try all_reduce, broadcast,
all_gather and send/recv on a CUDA tensor and print ``ok`` or the error.
A failed point-to-point call may abort its process, so each collective runs
in a fresh pair of processes.  ``parallel/comm.py`` moves CUDA tensors
through host copies on gloo groups because of what this prints.

    python examples/probe_gloo_cuda_torch.py
"""
import datetime
import socket
import subprocess
import sys

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "send_recv")


def _worker(rank: int, port: int, name: str) -> int:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=30))
    x = torch.full((4,), float(rank + 1), device="cuda")
    if name == "all_reduce":
        dist.all_reduce(x)
        ok = x.eq(3.0).all()
    elif name == "broadcast":
        dist.broadcast(x, 0)
        ok = x.eq(1.0).all()
    elif name == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = parts[1].eq(2.0).all()
    else:
        if rank == 0:
            dist.send(x, 1)
            ok = True
        else:
            y = torch.empty_like(x)
            dist.recv(y, 0)
            ok = y.eq(1.0).all()
    torch.cuda.synchronize()
    print(f"rank {rank} {name}: {'ok' if bool(ok) else 'wrong values'}", flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    for name in COLLECTIVES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), str(port), name],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            lines = [ln for ln in out.splitlines() if ln.startswith("rank") or "what()" in ln]
            if p.returncode and out.strip():
                lines.append(out.strip().splitlines()[-1])      # the error that ended it
            print(f"{name} rank {r}: exit {p.returncode}; " + " | ".join(lines)[:300])
    return 0


if __name__ == "__main__":
    sys.exit(main())
