"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files, and the cells in which each metric is read."""
import json
import os
import re

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_sizes():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    for word in b["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_text():
    b = load()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
    for c in b["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys():
    b = load()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def cells_of(metric, b):
    return set(metric.get("workloads", [w["name"] for w in b["workloads"]]))


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    b = load()
    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for w in b["workloads"]:
        n = w["name"]
        e2e = [m for m in b["end_to_end"]
               if m["name"] != "setup_s" and n in cells_of(m, b)]
        assert e2e, n
        assert any(n in cells_of(m, b) for m in b["per_layer"]), n


def test_each_layer_metric_is_read_where_its_end_to_end_metric_is():
    b = load()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert cells_of(m, b) <= cells_of(e2e[m["moves"]], b), m["name"]


def test_each_cell_and_metric_has_its_files():
    b = load()
    here = os.path.join(ROOT, "portbench")
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py")), m["name"]
    for w in b["workloads"]:
        with open(os.path.join(here, "traffic", w["traffic"] + ".json")) as f:
            job = json.load(f)["job"]
        assert os.path.exists(os.path.join(here, "jobs", job + ".py"))
        assert os.path.exists(os.path.join(
            here, "limits", f"{w['config']}.{job}.json"))


def test_one_layer_name_a_layer():
    """Metrics of one layer give the same layer text, letter for letter:
    a module named in two layer texts is one layer."""
    b = load()
    by_module = {}
    for m in b["per_layer"]:
        for word in re.findall(r"[\w/]+\.(?:py|cu)", m["layer"]):
            by_module.setdefault(word, set()).add(m["layer"])
    for module, layers in by_module.items():
        assert len(layers) == 1, (module, layers)
