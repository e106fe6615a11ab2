"""The harness: finds a cell's files by the names ``BENCHMARK.json`` gives,
runs the cell's driver in a closed loop for the window, reads the traced
window into per-layer metrics, judges the outputs and assembles the
result line.

Files, by name:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (its
  ``"driver"`` names ``drivers/<driver>.py``);
* ``traffic/<traffic>.json``: the traffic mix (its ``"generator"`` names
  the generator ``traffic/<generator>.py``);
* ``workloads/<cell>.json``: the cell's check (batches judged, the limit of
  each number compared) and its traced batches;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``
  returning a number or None.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from gpu_bench import host
from gpu_bench.generators import derive_seed

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what the process may not hold once the window has closed (top-level names)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "points_matching_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def bench_dir(root: str) -> str:
    return os.path.join(root, "gpu_bench")


def resolve(bench: dict, name: str, root: str = ROOT) -> dict:
    """Everything one cell needs, found by name: its entry, configuration,
    traffic mix and its generator's path, cell file, end-to-end metrics and
    per-layer metrics (each with its reader's path)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    base = bench_dir(root)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [dict(m, reader=os.path.join(base, "metrics", m["name"] + ".py"))
             for m in bench["per_layer"] if name in m["workloads"]]
    traffic = _json(os.path.join(base, "traffic", cell["traffic"] + ".json"))
    return dict(cell=cell,
                config=_json(os.path.join(root, config_entry["file"])),
                config_entry=config_entry, traffic=traffic,
                generator=os.path.join(base, "traffic", traffic["generator"] + ".py"),
                workload=_json(os.path.join(base, "workloads", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def list_all(root: str = ROOT) -> dict:
    """Every cell resolved: its configuration, traffic, cell file, driver,
    generator and the per-layer readers it reports (each checked to
    exist)."""
    bench = load_benchmark(root)
    out = {}
    for w in bench["workloads"]:
        spec = resolve(bench, w["name"], root)
        driver = os.path.join(bench_dir(root), "drivers", spec["config"]["driver"] + ".py")
        for path in [driver, spec["generator"]] + [m["reader"] for m in spec["per_layer"]]:
            if not os.path.exists(path):
                raise FileNotFoundError(path)
        out[w["name"]] = dict(config=w["config"], traffic=w["traffic"],
                              driver=spec["config"]["driver"],
                              generator=spec["traffic"]["generator"],
                              end_to_end=[m["name"] for m in spec["end_to_end"]],
                              per_layer=[m["name"] for m in spec["per_layer"]])
    return out


def load_reader(path: str) -> Callable:
    """A per-layer metric's ``read`` function, from its file."""
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_for(spec: dict, dev, seed: int):
    mod = importlib.import_module("gpu_bench.drivers." + spec["config"]["driver"])
    return mod.Driver(spec, dev, seed)


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from the
    seed: which batches the check judges."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Window:
    """What the closed loop measured."""
    t0: float
    t_end: float
    latencies: List[float]
    batches: int
    units: int
    kept: List[dict]
    setup_s: float
    traced: int


def closed_loop(driver, seconds: float, in_flight: int, kept: Reservoir,
                profiler=None, lead: int = 0, traced: int = 0,
                agree: Callable[[bool], bool] = bool) -> Window:
    """Batches back to back, ``in_flight`` of them enqueued before the
    oldest is read: batch k+1 is enqueued before the host waits for batch
    k.  Runs until ``seconds`` have passed (and at least as many batches as
    the check judges, and the traced batches, if any, are done), then reads
    the batches still in flight.  With a profiler,
    batches ``lead`` .. ``lead + traced - 1`` are traced: the queue drains
    before the trace stops, so each traced batch runs whole inside it.
    ``agree`` turns this rank's wish to go on into every rank's (rank 0's),
    so the ranks of a cell on several chips run the same batches."""
    queue = collections.deque()
    lat, units, done = [], 0, 0
    last = [0.0]

    def finish(item):
        nonlocal units, done
        driver.complete(item)
        last[0] = item["t_done"]
        lat.append(item["t_done"] - item["t_enq"])
        units += item["units"]
        done += 1
        kept.offer(item)

    stop_trace = lead + traced if profiler is not None else 0
    least = max(stop_trace, kept.size)
    setup_s = host.process_age_s()
    t0 = time.perf_counter()
    k = 0
    while agree(time.perf_counter() - t0 < seconds or k < least):
        if profiler is not None and k == lead:
            profiler.start()
        if profiler is not None and k == stop_trace:
            while queue:
                finish(queue.popleft())
            profiler.stop()
        item = driver.enqueue(traced=profiler is not None and lead <= k < stop_trace)
        queue.append(item)
        k += 1
        while len(queue) >= in_flight:
            finish(queue.popleft())
    while queue:
        finish(queue.popleft())
    if profiler is not None and k == stop_trace:
        profiler.stop()
    return Window(t0=t0, t_end=last[0], latencies=lat, batches=done, units=units,
                  kept=kept.items, setup_s=setup_s, traced=traced if profiler else 0)


class Ranks:
    """The processes of a cell on ``world`` chips, one a chip: this one's
    rank, the default process group (NCCL on the card, gloo on the CPU) the
    program's mesh is made over, a gloo group on the host for agreeing on
    when the window closes and gathering readings, and, on rank 0, the
    other ranks' processes, which it starts and waits for."""

    def __init__(self, rank: int, world: int, port: int, dev: torch.device):
        import torch.distributed as dist

        from points_matching_tpu_torch.parallel.mesh import initialize_distributed

        self.rank, self.world, self.dist = rank, world, dist
        initialize_distributed(backend="nccl" if dev.type == "cuda" else "gloo",
                               init_method=f"tcp://localhost:{port}", world_size=world,
                               rank=rank, timeout=RANK_TIMEOUT_S)
        self.host = dist.new_group(backend="gloo")

    def agree(self, go: bool) -> bool:
        flag = torch.tensor([int(go)])
        self.dist.broadcast(flag, 0, group=self.host)
        return bool(flag.item())

    def gather(self, obj) -> Optional[list]:
        """Every rank's ``obj`` on rank 0 (None elsewhere)."""
        out = [None] * self.world if self.rank == 0 else None
        self.dist.gather_object(obj, out, dst=0, group=self.host)
        return out

    def close(self) -> None:
        self.dist.destroy_process_group()


# the rendezvous and every collective of a multi-chip cell fail after this
RANK_TIMEOUT_S = 120.0


def free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(name: str, seed: int, seconds: float, trace: bool, dev_type: str, root: str,
                world: int, port: int, logs: str) -> list:
    """Ranks 1 .. world − 1 of a cell as processes of their own (each on its
    own chip), their output in ``logs``."""
    procs = []
    for r in range(1, world):
        code = (f"import sys; sys.path.insert(0, {root!r}); from gpu_bench.harness import "
                f"rank_main; sys.exit(rank_main({name!r}, {seed}, {seconds}, {trace}, "
                f"{dev_type!r}, {root!r}, {r}, {world}, {port}))")
        with open(os.path.join(logs, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                          stderr=subprocess.STDOUT, cwd=root))
    return procs


def stop_ranks(procs: list, logs: str, timeout: float) -> None:
    """Wait for the other ranks; kill those still running after ``timeout``
    seconds; raise, with the end of its log, if one failed."""
    deadline = time.perf_counter() + timeout
    for p in procs:
        try:
            p.wait(max(0.1, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    for r, p in enumerate(procs, 1):
        if p.returncode != 0:
            with open(os.path.join(logs, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{tail}")


def rank_main(name: str, seed: int, seconds: float, trace: bool, dev_type: str, root: str,
              rank: int, world: int, port: int) -> int:
    """A rank other than 0 of a multi-chip cell: the same run, no result."""
    dev = torch.device(dev_type, rank) if dev_type == "cuda" else torch.device(dev_type)
    run_cell(name, seed, seconds, trace, dev=dev, root=root, rank=rank, world=world, port=port)
    return 0


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader takes: the traced window's summary
    (``trace.summarize``; None in a run without a device trace), the
    program's counters, the frozen work of one batch by layer, and the
    card's peaks (None off a card)."""
    trace: Optional[dict]
    counters: Dict[str, float]
    work: dict
    peaks: Optional[dict]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit (value ≤ limit passes)."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    return {n: dict(value=numbers[n], limit=limits[n], ok=bool(numbers[n] <= limits[n]))
            for n in limits}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def say(*parts) -> None:
    print(*parts, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev=None,
             root: str = ROOT, rank: int = 0, world: Optional[int] = None,
             port: Optional[int] = None) -> Optional[dict]:
    """One run of a cell: set-up, the window, the traced batches (with
    ``trace``), the check.  Returns the result line as a dict; ``dev`` other
    than a CUDA device is a rehearsal (no device metric is reported).  A
    cell on several chips (``world``, by default its ``chips``) runs a rank
    a chip: rank 0 starts the others, and only it judges and returns."""
    bench = load_benchmark(root)
    spec = resolve(bench, name, root)
    world = spec["cell"]["chips"] if world is None else world
    dev = torch.device(dev or "cuda:0")
    procs, logs, ranks = [], None, None
    try:
        if world > 1:
            if rank == 0:
                port, logs = free_port(), tempfile.mkdtemp()
                procs = start_ranks(name, seed, seconds, trace, dev.type, root, world, port,
                                    logs)
            ranks = Ranks(rank, world, port, dev)
        return _run(spec, seed, seconds, trace, dev, ranks)
    finally:
        if procs:
            stop_ranks(procs, logs, RANK_TIMEOUT_S)
        if logs:
            import shutil

            shutil.rmtree(logs, ignore_errors=True)


def _run(spec: dict, seed: int, seconds: float, trace: bool, dev: torch.device,
         ranks: Optional[Ranks]) -> Optional[dict]:
    from gpu_bench.trace import Profiler
    from gpu_bench.work.peaks import peaks_for

    on_card = dev.type == "cuda"
    wl, mix = spec["workload"], spec["traffic"]
    if on_card:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = bool(spec["config"].get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(spec["config"].get("tf32", False))
    peaks = None
    if on_card:
        info = host.card()
        peaks = peaks_for(info["kind"])
        say(f"card: {info['kind']}; nvidia-smi name, power.limit, clocks.sm, clocks.max.sm, "
            f"clocks.mem, temperature: {info['nvidia_smi']}; peaks {json.dumps(peaks)}")
    else:
        say(f"rehearsal on {dev}: no device metric is reported")

    driver = driver_for(spec, dev, seed)
    t = time.perf_counter()
    driver.setup()
    say(f"set-up: inputs and warm-up {time.perf_counter() - t:.3f} s; "
        + json.dumps(driver.setup_notes()))
    if on_card:
        say(f"host eager launch {host.dispatch_us(dev):.3f} us (2,000 add_ calls, one sync)")

    profiler = Profiler() if trace else None
    kept = Reservoir(wl["check"]["batches"], derive_seed(seed, 9))
    win = closed_loop(driver, seconds, mix["in_flight"], kept, profiler,
                      wl["trace"]["lead"], wl["trace"]["batches"],
                      agree=ranks.agree if ranks else bool)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if ranks:
        peak = max(ranks.gather(peak) or [peak])
    window_s = win.t_end - win.t0
    say(f"window: {win.batches} {driver.batch_word} ({win.units} {driver.unit_word}) in "
        f"{window_s:.6f} s, {win.traced} traced; set-up {win.setup_s:.6f} s; peak device "
        f"memory {peak} bytes (the fullest chip)" + (
            f"; nvidia-smi after: {host.card()['nvidia_smi']}" if on_card else ""))
    counters = driver.counters()
    say("counters: " + json.dumps(counters))
    summary = profiler.read(driver.spans) if trace else None
    if ranks:
        busy = ranks.gather(summary and summary["busy_s"])
        if summary is not None and busy is not None:
            summary["busy_s"] = sum(busy) / len(busy)        # averaged over the chips
            say(f"busy seconds by rank: {busy}")
        driver.release()
        ranks.close()
        if ranks.rank != 0:
            return None

    metrics, device, breakdown = {}, None, None
    if on_card:
        device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                      count=ranks.world if ranks else 1, memory_peak_bytes=int(peak))
    if trace:
        view = RunView(trace=summary if on_card else None, counters=counters,
                       work=driver.work(), peaks=peaks)
        if summary is not None and on_card:
            device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            breakdown = dict(device_ops=[[n, s] for n, s in summary["device_ops"][:10]],
                             idle_gaps=[[n, s] for n, s in summary["idle_gaps"][:10]])
            say("trace: " + json.dumps({k: summary[k] for k in
                                        ("window_s", "busy_s", "device_ops_without_launch")}))
            say("trace spans: " + json.dumps(summary["spans"]))
            say("trace top device ops: " + json.dumps(summary["device_ops"][:15]))
            say("trace idle gaps: " + json.dumps(summary["idle_gaps"][:15]))
        for m in spec["per_layer"]:
            v = load_reader(m["reader"])(view)
            if v is not None and (on_card or m["source"] == "program_counter"):
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = driver.end_to_end(win)
        e2e["setup_s"] = win.setup_s
        for m in spec["end_to_end"]:
            if on_card and m["name"] in e2e:
                metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
        say("end to end: " + json.dumps(e2e))

    t = time.perf_counter()
    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.check(win.kept)
    checks = judge(numbers, wl["check"]["limits"])
    say(f"check: {len(win.kept)} {driver.batch_word} judged in {time.perf_counter() - t:.3f} s; "
        "readings not compared: " + json.dumps({k: v for k, v in numbers.items()
                                                 if k not in checks}))
    correct = all(c["ok"] for c in checks.values())
    result = dict(correct=correct, attempted=win.units, failed=0,
                  metrics=metrics, device=device)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if not on_card:
        result["rehearsal"] = True
    result["checks"] = {n: dict(value=c["value"], limit=c["limit"]) for n, c in checks.items()}
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    return result
