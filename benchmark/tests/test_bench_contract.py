"""BENCHMARK.json and every file it points to: found, and within the
names, sizes and keys the benchmark's contract allows."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    script = bench["command"][1]
    assert any(script.startswith(p + "/") for p in bench["paths"])


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in data for k in c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (spec.BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        check = json.loads(
            (spec.BENCH / "checks" / f"{w['name']}.json").read_text())
        assert check["control"] in ("fp32", "tf32", "fp8")
        assert check["limits"]
        spec.load_cell(w["name"])


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    per_layer = bench["per_layer"]
    names = [m["name"] for m in bench["end_to_end"] + per_layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= \
            set(e2e[m["moves"]].get("workloads", cells))
    for m in bench["end_to_end"] + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert callable(spec.metric_reader(m["name"]))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_every_cell_reports_enough(bench, cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer


def test_kernel_patterns():
    patterns = spec.kernel_patterns()
    assert patterns
    for p in patterns:
        assert NAME.match(p["class"]) and p["patterns"]
    assert spec.classify_kernel(
        "void (anonymous namespace)::conv_wgmma_kernel<0, 2>(x)",
        patterns) == "conv"
    assert spec.classify_kernel("void at::native::reduce_kernel<512>",
                                patterns) is None


def test_files_under_paths_are_named_from_names(bench):
    for p in bench["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert PATH.match(str(f.relative_to(spec.ROOT))), f
