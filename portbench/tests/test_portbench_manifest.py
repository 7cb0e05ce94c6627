"""BENCHMARK.json against the benchmark's contract, and every cell found by
name; a new cell, mix and metric added as new files only."""
import json
import re
import shutil
import statistics

import pytest

from portbench.harness import core

ROOT = core.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expansion",
               "experts_per_tok", "dim", "ffn", "width")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word == p or word.startswith(p + "/") for p in MANIFEST["paths"])


def test_run_seconds_fit_the_check_with_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
    metric_names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MANIFEST["end_to_end"]} >= {"setup_s"}
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16 and 1 <= len(MANIFEST["per_layer"]) <= 128


def test_configs_files_and_reduced():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert 1 <= len(MANIFEST["configs"]) <= 24
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MANIFEST["paths"]))
        assert (ROOT / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)


def test_workloads():
    wl = MANIFEST["workloads"]
    assert 1 <= len(wl) <= 24
    assert len({(w["config"], w["traffic"]) for w in wl}) == len(wl)
    for w in wl:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in wl) <= max(1, len(wl) // 4)


def test_per_layer_entries():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells and core.applies(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())   # one spelling per layer


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_found_by_name(cell):
    c = core.find_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert hasattr(core.generator_module(c), "run")
    for m in c.per_layer:
        assert callable(core.metric_reader(c, m["name"]))
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    assert (ROOT / c.config["reference"]).is_file()


def test_bench_files_named_from_name_characters():
    for p in MANIFEST["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert all(NAME.match(part) for part in rel.split("/")), rel


def test_readers_return_nothing_when_nothing_to_read():
    for w in MANIFEST["workloads"]:
        c = core.find_cell(w["name"])
        for m in c.per_layer:
            assert core.metric_reader(c, m["name"])({"kind": "other"}) is None


def test_a_new_cell_mix_and_metric_take_only_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a metric and
    their manifest entries, and run the new cell tiny on the CPU: no file
    that was there is edited."""
    bench = tmp_path / "portbench"
    shutil.copytree(core.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((core.BENCH_DIR / "configs" / "maze-planner-384.json").read_text())
    cfg.update(d_model=32, n_layers=2, n_heads=2, d_ff=64, d_cond=16, maze_channels=[4, 8],
               grid=9, T=16, K=4, levels=2, K_min=4, ddim_steps=5, n_train=20)
    (bench / "configs" / "maze-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "maze-b16-dense.json").write_text(json.dumps(
        {"generator": "maze_plan", "policy": "dense", "batch": 16, "occupancy": 0.3,
         "warmup_calls": 1, "check_rows": 16, "trace_calls": 1}))
    (bench / "metrics" / "calls_per_s.plan.py").write_text(
        "def read(run):\n    return run['calls'] / run['window_s'] if run.get('calls') else None\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "maze-tiny", "source": "test", "reduced": [],
                                "file": "portbench/configs/maze-tiny.json", "why": "test"})
    manifest["workloads"].append({"name": "maze-tiny.dense", "config": "maze-tiny",
                                  "traffic": "maze-b16-dense", "chips": 1, "why": "test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "plan_samples_per_s":
            m["workloads"].append("maze-tiny.dense")
    manifest["per_layer"].append({"name": "calls_per_s.plan", "unit": "1/s", "better": "higher",
                                  "source": "host_clock", "layer": "the whole planner call",
                                  "moves": "plan_samples_per_s",
                                  "workloads": ["maze-tiny.dense"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = core.find_cell("maze-tiny.dense", bench_dir=bench, root=tmp_path)
    out = core.generator_module(cell).run(cell, 5, 0.2, False, device="cpu")
    line = core.result_line(cell, out, trace=True)
    assert line["metrics"]["calls_per_s.plan"]["value"] > 0
    assert core.result_line(cell, out, trace=False)["metrics"]["plan_samples_per_s"]["value"] > 0
    after = {p.relative_to(tmp_path): p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_quartile_spread_and_percentile():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert core.quartile_spread(xs) == pytest.approx((q3 - q1) / med)
    assert core.percentile(list(range(11)), 90) == pytest.approx(9.0)
