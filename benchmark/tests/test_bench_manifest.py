"""BENCHMARK.json keeps its contract, and every cell resolves to its files."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all("/" not in w or w.startswith("benchmark") for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits: 2 + 14 x cells runs of run_seconds + 60 s,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in BENCH[group]:
            assert set(entry) == keys, entry
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    from benchmark.core import manifest

    c = manifest.cell(cell, ROOT)
    assert (ROOT / "benchmark" / "drivers" / f"{c.traffic['kind']}.py").is_file()
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        reader = _module(ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (
            m["source"], m["layer"], m["moves"])


def _kinds(config_name: str) -> set:
    return {json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json")
                       .read_text())["kind"]
            for w in BENCH["workloads"] if w["config"] == config_name}


def cuts_stated(entry: dict, conf: dict) -> bool:
    """Every key that the manifest's `reduced` lists is in the configuration
    file at the value run, and in the file's `reduced` object with the
    published value it was cut from and the deployment that it stands for;
    the object lists no other key.  An empty list needs no object."""
    stated = conf.get("reduced", {})
    return set(stated) == set(entry["reduced"]) and all(
        k in conf and {"published", "stands_for"} <= set(stated[k])
        and stated[k]["published"] != conf[k] for k in stated)


@pytest.mark.parametrize("listed,stated,ok", [
    ([], None, True),
    (["levels"], {"levels": {"published": 4, "stands_for": "raft-things at 1080p"}},
     True),
    (["levels"], None, False),
    (["levels"], {"levels": {"published": 4}}, False),
    (["levels"], {"levels": {"published": 3, "stands_for": "raft-things"}}, False),
    ([], {"levels": {"published": 4, "stands_for": "raft-things"}}, False),
])
def test_a_cut_is_listed_with_its_published_value(listed, stated, ok):
    conf = {"levels": 3}
    if stated is not None:
        conf["reduced"] = stated
    assert cuts_stated({"reduced": listed}, conf) is ok


def test_configs_state_their_source_and_cuts():
    from deflicker_torch.config import AtlasConfig

    from benchmark import flowmodels

    reference_keys = set(AtlasConfig().to_reference_json())
    for entry in BENCH["configs"]:
        assert entry["file"].startswith("benchmark/configs/")
        conf = json.loads((ROOT / entry["file"]).read_text())
        assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
        assert cuts_stated(entry, conf), entry["name"]
        assert conf["assumed"]
        kinds = _kinds(entry["name"])
        assert kinds, entry["name"]
        if "fit" in kinds:
            assert reference_keys <= set(conf["atlas"])
            AtlasConfig(**conf["atlas"])
        if "flow" in kinds:
            model = flowmodels.of(conf)
            assert all(callable(getattr(model, k)) for k in flowmodels.API)
            assert {"iters", "dtype", "pair_batch"} <= set(model.settings(conf))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_drivers_control_and_faults(cell):
    """calibrate.py reaches every cell through its driver alone: `sound`,
    `control` and `faults`, each fault a context manager that patches the
    program while it is open."""
    from benchmark import run
    from benchmark.core import manifest

    c = manifest.cell(cell, ROOT)
    driver = run.driver(c)
    assert callable(driver.sound) and callable(driver.control)
    faults = driver.faults(c)
    assert faults and all(NAME.match(name) for name in faults)
    for plant in faults.values():
        with plant():
            pass


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "benchmark" / "metrics").glob("*.py")}
    assert files == listed
