"""The harness is driven by data: every cell of ``BENCHMARK.json`` resolves to
its files, a new configuration, cell and per-layer metric are found from new
files and entries alone, ``BENCHMARK.json`` keeps to the benchmark's
contract, and each driver rehearses end to end on the CPU (labelled a
rehearsal, with no device metric)."""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpu_bench import generators, harness, rehearsal  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return harness.load_benchmark(ROOT)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_resolves_to_its_files():
    listed = harness.list_all(ROOT)
    bench = _bench()
    assert list(listed) == [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        spec = harness.resolve(bench, w["name"], ROOT)
        assert os.path.exists(os.path.join(ROOT, "gpu_bench", "drivers",
                                           spec["config"]["driver"] + ".py"))
        gen = generators.load(spec["generator"])
        assert callable(gen.make) and isinstance(gen.TINY, dict)
        for m in spec["per_layer"]:
            assert callable(harness.load_reader(m["reader"]))
        limits = spec["workload"]["check"]["limits"]
        assert limits and all(v >= 0 for v in limits.values())


def test_benchmark_json_keeps_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "gpu_bench/run.py"] and b["paths"] == ["gpu_bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gpu_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert _line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())           # one spelling a layer
    for cell in cells:
        spec = harness.resolve(b, cell, ROOT)
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_config_cell_generator_and_metric_are_found_from_files_alone(tmp_path):
    root = rehearsal.tiny_copy(str(tmp_path / "bench"))
    base = os.path.join(root, "gpu_bench")
    with open(os.path.join(base, "traffic", "pairs.py")) as f:
        source = f.read()
    with open(os.path.join(base, "traffic", "pairs_clean.py"), "w") as f:
        f.write(source.replace("def make(", "def _make(") + (
            "\n\ndef make(mix, dim, gen, dev):\n"
            "    return _make(dict(mix, outlier_share=0.0), dim, gen, dev)\n"))
    with open(os.path.join(base, "configs", "verify_surf64.json")) as f:
        config = json.load(f)
    config["matcher"]["ratio"] = 0.7
    with open(os.path.join(base, "configs", "verify_lowe07.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(base, "traffic", "pairs_8k.json")) as f:
        mix = json.load(f)
    with open(os.path.join(base, "traffic", "pairs_tiny.json"), "w") as f:
        json.dump(dict(mix, pairs=2, generator="pairs_clean"), f)
    with open(os.path.join(base, "workloads", "verify-tiny.json"), "w") as f:
        json.dump(dict(check=dict(batches=1, consensus_pairs=2, limits=dict(
            match_margin=1e-4, points_wrong=0, gate_margin=1e-2, pairs_malformed=0,
            consensus_short=0.5)), trace=dict(lead=1, batches=1)), f)
    with open(os.path.join(base, "metrics", "host.matches.tiny.py"), "w") as f:
        f.write("def read(run):\n    return run.counters.get('aten_ops_per_batch')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="verify_lowe07", source="x", file="gpu_bench/configs/verify_lowe07.json",
                             reduced=[], why="a stricter ratio"))
    b["workloads"].append(dict(name="verify-tiny", config="verify_lowe07", traffic="pairs_tiny",
                               chips=1, why="two pairs"))
    for m in b["end_to_end"]:
        if "workloads" in m and "verify-8k" in m["workloads"]:
            m["workloads"].append("verify-tiny")
    b["per_layer"].append(dict(name="host.matches.tiny", unit="ops/batch", better="lower",
                               source="program_counter", layer="entry and host dispatch",
                               moves="verify_batch_p95_ms", workloads=["verify-tiny"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    out = subprocess.run([sys.executable, os.path.join(root, "gpu_bench", "run.py"), "--list"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    listed = json.loads(out.stdout)
    assert listed["verify-tiny"]["config"] == "verify_lowe07"
    assert listed["verify-tiny"]["traffic"] == "pairs_tiny"
    assert listed["verify-tiny"]["generator"] == "pairs_clean"
    assert listed["verify-tiny"]["per_layer"] == ["host.matches.tiny"]
    r = harness.run_cell("verify-tiny", 5, 0.2, True, dev="cpu", root=root)
    assert r["rehearsal"] and r["metrics"]["host.matches.tiny"]["value"] > 0


@pytest.mark.parametrize("cell", ["verify-8k", "retrieval-8k", "verify-wide", "retrieval-ring4"])
@pytest.mark.parametrize("trace", [0, 1])
def test_each_driver_rehearses_on_the_cpu(tmp_path, cell, trace):
    """(``retrieval-ring4``, a cell the test adds: four processes in a gloo
    group, as on four chips.)"""
    root = rehearsal.tiny_copy(str(tmp_path / "bench"))
    rehearsal.add_ring_cell(root)
    r = harness.run_cell(cell, 2**33 + 1, 0.3, bool(trace), dev="cpu", root=root)
    assert r["rehearsal"] is True and r["device"] is None and r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    spec = harness.resolve(harness.load_benchmark(root), cell, root)
    sources = {m["name"]: m["source"] for m in spec["per_layer"]}
    assert all(sources.get(n) == "program_counter" for n in r["metrics"])   # no device metric
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(spec["workload"]["check"]["limits"])


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "gpu_bench", "run.py"),
                          "--workload", "verify-8k", "--seed", str(2**40), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    """A checkout of ``BENCHMARK.json`` and ``gpu_bench/`` alone cannot run."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gpu_bench"), tmp_path / "gpu_bench")
    code = ("import sys; sys.path.insert(0, %r); from gpu_bench import harness; "
            "harness.run_cell('verify-8k', 1, 0.1, False, dev='cpu', root=%r)"
            % (str(tmp_path), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and "points_matching_tpu_torch" in out.stderr
