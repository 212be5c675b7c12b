"""BENCHMARK.json against its format and limits, and discovery by name of
every configuration, traffic mix and metric it lists."""
import json
import re

import pytest

from _ffpbench_cells import BENCH, CELLS, ROOT
from ffpbench import find, metrics, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p + "/") for p in BENCH["paths"]), w
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entries():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["name"] not in seen
        seen.add(c["name"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])
    pairs, names = set(), set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in seen and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        assert w["name"] not in names
        pairs.add((w["config"], w["traffic"]))
        names.add(w["name"])
        four += w["chips"] == 4
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert {w["config"] for w in BENCH["workloads"]} == seen
    metric_names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", [])) <= names
    for m in BENCH["end_to_end"]:
        assert set(m) <= METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or m["name"].startswith(
                "roofline."):
            assert m["unit"] == "%"
        layers.setdefault(m["name"], m["layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name_and_reports_what_it_must(name):
    cell = run.load_cell(name)
    assert cell["config"]["name"] == name.split(".")[0]
    assert cell["traffic"]["clients"] == 1
    assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2
    assert cell["per_layer"]
    for m in BENCH["per_layer"]:
        if name in m.get("workloads", [name]):
            assert m["moves"] in cell["end_to_end"]
            assert m["name"] in cell["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_pass_delay_and_system_kinds_found_by_name(name):
    cell = run.load_cell(name)
    ps = find.piece("passes", cell["traffic"]["pass"])
    assert all(callable(getattr(ps, f)) for f in ("program", "draws",
                                                  "decide"))
    assert callable(find.piece("delays",
                               cell["config"]["delay"]["kind"]).sample)
    for entry in cell["config"]["systems"]:
        sk = find.piece("systems", entry["kind"])
        assert callable(sk.port) and callable(sk.reference)
    with pytest.raises(ValueError):
        find.piece("passes", "../run")


@pytest.mark.parametrize("change, refusal", [
    ({"clients": 4}, "one client"),
    ({"chunk": 1 << 22, "trials_per_request": 1 << 22}, "more than one chunk"),
])
def test_a_mix_the_loop_cannot_run_is_refused(tmp_path, change, refusal):
    (tmp_path / "ffpbench" / "traffic").mkdir(parents=True)
    (tmp_path / "ffpbench" / "configs").mkdir()
    w = BENCH["workloads"][0]
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    (tmp_path / cfg["file"]).write_text((ROOT / cfg["file"]).read_text())
    tr = json.loads((ROOT / "ffpbench" / "traffic" /
                     f"{w['traffic']}.json").read_text())
    (tmp_path / "ffpbench" / "traffic" / f"{w['traffic']}.json").write_text(
        json.dumps(dict(tr, **change)))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    with pytest.raises(ValueError, match=refusal):
        run.load_cell(w["name"], root=tmp_path)


def test_every_metric_has_a_reader_and_every_file_is_listed():
    listed = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for name in listed:
        assert callable(metrics.load(name).read)
    files = {p.stem for p in metrics.HERE.glob("*.py")} - {"__init__"}
    assert files == listed
    traffic = {p.stem for p in (ROOT / "ffpbench" / "traffic").glob("*.json")}
    assert traffic == {w["traffic"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
