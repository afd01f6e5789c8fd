"""Isolation and the manifest: nothing under ``portbench/`` imports JAX or
the JAX package (top-level module names compared whole), the plain
references import nothing of the program either, and ``BENCHMARK.json``
keeps to its contract's names, units and links."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "automerge_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of the modules a source file imports (relative
    imports stay inside ``portbench``)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                out.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                out.add(arg.values[0].value.split(".")[0])
    return out


def _sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not (_imports(p) & FORBIDDEN), p


def test_the_references_import_nothing_of_the_program():
    for p in sorted((BENCH / "reference").glob("*.py")):
        names = _imports(p)
        assert not (names & (FORBIDDEN | {"automerge_tpu_torch"})), (p, names)
        assert names <= {"__future__", "numpy"}, (p, names)


def test_a_run_loads_neither_jax_nor_the_jax_package(small):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        f"small = {small!r}\n"
        "bench = harness.load_benchmark()\n"
        "for w in bench['workloads']:\n"
        "    for trace in (False, True):\n"
        "        r = harness.run_cell(bench, w['name'], 3, 0.2, trace, 'cpu',\n"
        "                             cfg_override=small[w['config']])\n"
        "        assert r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "automerge_tpu_torch" in loaded
    assert not (loaded & FORBIDDEN), loaded & FORBIDDEN


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_units_and_files(bench):
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        names.append(c["name"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg, k
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {c["config"] for c in bench["workloads"]} == {c["name"] for c in bench["configs"]}


def test_every_metric_moves_an_end_to_end_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    reports = {c: {m["name"] for m in bench["end_to_end"]
                   if c in m.get("workloads", cells)} for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert m["workloads"] and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
    for c in cells:
        assert any(c in m["workloads"] for m in bench["per_layer"]), c


def test_the_run_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "edit_trace_1024.fanin",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not out.stdout.strip()
