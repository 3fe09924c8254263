"""BENCHMARK.json against the contract's forms, and the harness finding
every cell, configuration, traffic mix and metric by name, a new one too."""

import json
import re
import shutil

import pytest

from harness import cells

ROOT = cells.ROOT
BENCH = cells.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config",
                                                          "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert LINE.match(text), text
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in BENCH[k]]
        assert len(ns) == len(set(ns)), k


def test_end_to_end_and_per_layer_metrics():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "sim_steps_per_s", "segment_ms_p90", "setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cellnames = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "sim_steps_per_s"
        assert set(m["workloads"]) <= cellnames and m["workloads"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = cells.resolve(workload, ROOT)
    assert cell.config["check"]["limits"]
    assert cell.traffic["world"]["num_boxes"] >= 1
    assert {m["name"] for m in cell.end_to_end} == {
        "sim_steps_per_s", "segment_ms_p90", "setup_s"}
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.metric_reader(metric, ROOT))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_check_layer_has_a_reader(config):
    (entry,) = [c for c in BENCH["configs"] if c["name"] == config]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["check"]["layers"]
    for layer in cfg["check"]["layers"]:
        mod = cells.check_reader(layer, ROOT)
        assert callable(mod.read) and mod.HOOKS


def test_every_config_file_is_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench_port/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["source"]) <= 200


def test_a_new_cell_is_found_without_edits(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a layer of
    the check added as new files (and entries) in a copy are resolved with
    no file edited."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench_port/configs/expert_vision.json")
                     .read_text())
    cfg["envs"] = 64
    cfg["check"]["layers"] = ["render", "fuse_2d"]
    (tmp_path / "bench_port/configs/expert_small.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "bench_port/traffic/rand10.json").read_text())
    mix["world"]["num_boxes"] = 15
    (tmp_path / "bench_port/traffic/rand15.json").write_text(json.dumps(mix))
    (tmp_path / "bench_port/metrics/segments_read.py").write_text(
        "def read(ctx):\n    return ctx['segments']\n")
    (tmp_path / "bench_port/checks/fuse_2d.py").write_text(
        "HOOKS = (('neoplanner_tpu_torch.mapping.occupancy', "
        "'insert_depth_2d'),)\n\n\ndef read(cap, exact, low, control, "
        "system):\n    return {}\n")
    bench["configs"].append({"name": "expert_small", "source": "x",
                             "file": "bench_port/configs/expert_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "expert_small.rand15",
                               "config": "expert_small", "traffic": "rand15",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "segments_read", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "closed loop",
                               "moves": "sim_steps_per_s",
                               "workloads": ["expert_small.rand15"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.resolve("expert_small.rand15", tmp_path)
    assert cell.config["envs"] == 64
    assert cell.traffic["world"]["num_boxes"] == 15
    assert [m["name"] for m in cell.per_layer] == ["segments_read"]
    assert cells.metric_reader("segments_read", tmp_path)({"segments": 7}) \
        == 7
    assert [cells.check_reader(n, tmp_path).HOOKS[0][1]
            for n in cell.config["check"]["layers"]] == [
        "render_depth_auto", "insert_depth_2d"]
    with pytest.raises(KeyError):
        cells.resolve("expert_small.rand99", tmp_path)


def test_run_without_a_card_exits_2_and_prints_nothing():
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_port/run.py"), "--workload",
         "expert_vision.rand10", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout == ""


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    from harness.runner import forbidden_modules
    import neoplanner_tpu_torch  # noqa: F401  (the port's name is allowed)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "neoplanner_tpu.sim",
                        types.ModuleType("y"))
    assert forbidden_modules() == ["jax", "neoplanner_tpu"]
