"""Every cell, configuration, traffic mix, limit and metric resolves by
name, and the manifest keeps to the benchmark's contract."""

import json
import re

import pytest

from portbench.harness import core, runner

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = core.manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    entry, config, traffic, limits = core.find_cell(cell)
    assert entry["chips"] in (1, 4)
    assert (core.BENCH / "entries" / f"{traffic['entry']}.py").exists()
    assert limits and all(v >= 0 for v in limits.values())
    assert config["name"] == entry["config"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_its_metrics(cell):
    e2e = [m["name"] for m in runner.metric_specs(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = runner.metric_specs(cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_metric_reader_resolves(metric):
    mod = runner.load_file(core.BENCH / "metrics" / f"{metric}.py")
    assert callable(mod.read)


@pytest.mark.parametrize("config", MANIFEST["configs"])
def test_config_file(config):
    f = core.load_json(core.ROOT / config["file"])
    assert f["name"] == config["name"] and f["reduced"] == config["reduced"]
    assert config["file"].startswith("portbench/")


def test_forbidden_modules_compare_whole_names():
    assert core.forbidden_modules(["jax.numpy", "fiber_torch.ops",
                                   "flaxen"]) == ["jax"]
    assert core.forbidden_modules(["fiber_tpu.models"]) == ["fiber_tpu"]
    assert core.forbidden_modules(["fiber_torch", "jaxtyping"]) == []
