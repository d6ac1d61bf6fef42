"""BENCHMARK.json against the benchmark's contract: keys, names, units,
limits of length, and that every name finds its file."""
import json
import re

from bench import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token", "edge_factor")


def one_line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (ROOT / word).is_file()


def test_run_seconds_fits_a_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24  # later PRs may add cells up to the limit
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)
            assert body["published"][key] != body[key]
        # every key the source publishes and the file does not list as
        # reduced is as published
        for key, value in body["published"].items():
            if key not in c["reduced"]:
                assert body[key] == value, key
        assert (ROOT / "bench" / "generators"
                / f"{body['generator']}.py").is_file()


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        mix = json.loads((ROOT / "bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        for package, key in (("adapters", "adapter"), ("loops", "loop"),
                             ("reference", "check")):
            assert (ROOT / "bench" / package / f"{mix[key]}.py").is_file()


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m.get("workloads", cells)) <= moved
        if "roofline" in m["name"]:  # a share of a kernel's roofline
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        package = "end_to_end" if m in SPEC["end_to_end"] else "metrics"
        assert (ROOT / "bench" / package / f"{m['name']}.py").is_file()


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            if "__pycache__" in rel or "/out/" in rel + "/":
                continue
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
