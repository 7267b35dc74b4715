"""The benchmark's layout: a configuration, a traffic mix, a cell and a
per-layer metric are found by name from files of their own; every cell
names files that exist; nothing imports JAX or the JAX package, and the
reference imports nothing of the program; BENCHMARK.json keeps to the
shapes its reader expects."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pose_transfer_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside the package)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert "pose_transfer_torch" not in _imports(path), path
        assert "portbench" not in _imports(path), path


def test_forbidden_names_compare_whole():
    from portbench import run
    before = dict(sys.modules)
    try:
        sys.modules["pose_transfer_torch_x"] = object()
        sys.modules["jaxlib.foo"] = object()
        assert run.forbidden_modules() == ["jaxlib.foo"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_every_cell_names_files_that_exist():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        work = json.loads((ROOT / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert (work["config"], work["traffic"], work["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert (REPO / configs[w["config"]]["file"]).exists()
        mix = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (ROOT / "traffic" / f"{mix['kind']}.py").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_benchmark_json_shapes():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [m for m in bench["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
    assert len(json.dumps(bench)) < 64 * 1024


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_found_without_editing_a_file(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "fashion256.json").read_text())
    (pb / "configs" / "other.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "online-b4.json").write_text(json.dumps(
        {"kind": "open_loop", "batch_size": 4, "max_wait_ms": 5.0,
         "rate_per_s": 20.0, "arrival_seed": 0, "content_seed": 0,
         "missing_prob": 0.3, "sample": 8, "warmup_batches": 1}))
    (pb / "workloads" / "other-online-b4.json").write_text(json.dumps(
        {"config": "other", "traffic": "online-b4", "chips": 1,
         "limits": {"image_gap": 0.1}}))
    (pb / "metrics" / "serve.extra_ms.py").write_text(
        "def read(out, run):\n    return 1.5\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "other", "source": "x",
                             "file": "portbench/configs/other.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other-online-b4", "config": "other",
                               "traffic": "online-b4", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "serve_p95_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["other-online-b4"]})
    bench["per_layer"].append({"name": "serve.extra_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "serve_p95_ms",
                               "workloads": ["other-online-b4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json\n"
        "from portbench import run\n"
        "spec = run.cell_spec('other-online-b4')\n"
        "print(json.dumps({'kind': spec['mix']['kind'],\n"
        "  'config': spec['config']['image_size'],\n"
        "  'e2e': [m['name'] for m in spec['end_to_end']],\n"
        "  'layer': [m['name'] for m in spec['per_layer']],\n"
        "  'read': run.reader('serve.extra_ms')(None, None),\n"
        "  'file': run.__file__}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(tmp_path),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["kind"] == "open_loop" and got["config"] == [256, 256]
    assert set(got["e2e"]) == {"serve_p95_ms", "peak_mem_gib", "setup_s"}
    assert got["layer"] == ["serve.extra_ms"] and got["read"] == 1.5
    after = _digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_recipe_found_without_editing_a_file(tmp_path):
    """A configuration with the paper's Full recipe (a VGG19 content loss)
    reaches the program's ``GANConfig`` and the reference's ``Recipe``
    from its own files."""
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pb = tmp_path / "portbench"
    before = _digest(pb)
    cfg = json.loads((pb / "configs" / "fashion256.json").read_text())
    cfg.update({"name": "full", "content_loss_layer": "block1_conv2",
                "nn_loss_area_size": 5, "l1_penalty_weight": 1.0})
    (pb / "configs" / "full.json").write_text(json.dumps(cfg))
    work = json.loads((pb / "workloads" / "fashion256-train-b32.json")
                      .read_text())
    work["config"] = "full"
    (pb / "workloads" / "full-train-b32.json").write_text(json.dumps(work))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "full", "source": "x",
                             "file": "portbench/configs/full.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "full-train-b32", "config": "full",
                               "traffic": "train-b32", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fashion256-train-b32" in m.get("workloads", []):
            m["workloads"].append("full-train-b32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time\n"
        "from portbench import run\n"
        "from portbench.cell import Run\n"
        "from portbench.reference import train\n"
        "spec = run.cell_spec('full-train-b32')\n"
        "r = Run(cell=spec['name'], config=spec['config'], mix=spec['mix'],\n"
        "        limits=spec['work']['limits'], seed=3, seconds=1.0,\n"
        "        trace=False, device='cpu', t_start=time.perf_counter())\n"
        "c = r.program_config(spec['mix']['batch'])\n"
        "rec = train.recipe(spec['config'])\n"
        "print(json.dumps({'program': [c.content_loss_layer,\n"
        "  c.nn_loss_area_size, c.l1_penalty_weight, c.batch_size],\n"
        "  'reference': [rec.content_layer, rec.nn_area, rec.l1_weight],\n"
        "  'layer': sorted(m['name'] for m in spec['per_layer']),\n"
        "  'file': run.__file__}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": f"{tmp_path}:{REPO}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["program"] == ["block1_conv2", 5, 1.0, 32]
    assert got["reference"] == ["block1_conv2", 5, 1.0]
    assert "train.gen_phase_ms" in got["layer"]
    after = _digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_exits_without_the_program(tmp_path):
    """A directory of BENCHMARK.json and the benchmark alone runs no
    cell."""
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "fashion256-train-b32", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  json.loads((REPO / "BENCHMARK.json")
                                             .read_text())["workloads"]])
def test_cell_spec_lists_metrics(cell):
    from portbench import run
    spec = run.cell_spec(cell)
    assert spec["per_layer"] and "setup_s" in [m["name"] for m in
                                               spec["end_to_end"]]
