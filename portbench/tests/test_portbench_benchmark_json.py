"""``BENCHMARK.json`` against the files it names and its format's limits
(keys, counts, sizes, bounds): every cell's configuration, traffic mix and
metrics are found by name, and every name and unit uses only the allowed
characters."""

import json
import re

import pytest

from portbench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# a width may never be cut (reduced): sizes of hidden, state or projection,
# *_dim, *_rank, heads, expansion factors, experts per token
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expan|per_tok)")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    assert not any(w.startswith("/") or ".." in w for w in B["command"])
    for word in B["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in B["paths"])
            assert (spec.ROOT / word).exists()


def test_run_seconds_fits_a_full_check_of_24_cells():
    r = B["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys_and_legal_names(kind):
    entries = B[kind]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = set(e) - ENTRY_KEYS[kind]
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set()), e
        assert ENTRY_KEYS[kind] <= set(e), e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs_name_their_files_and_are_each_used():
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json" and c["file"] not in files
        files.add(c["file"])
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["source"].startswith("https://") and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_find_their_files_and_agree_with_them():
    four = [w for w in B["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"]) <= 24
    for w in B["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        cell = spec.cell(w["name"])             # raises where the cell's file disagrees
        assert (spec.HERE / "traffic" / f"{cell['traffic']['kind']}.py").exists()
        assert cell["check"]["sample"] >= 1 and cell["check"]["max_rel_gap"] >= 0


def test_bounds():
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in B["end_to_end"])


def test_every_metric_has_a_reader_and_every_cell_reports_enough():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert set(m.get("workloads", [])) <= cells
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for name in cells:
        mine = {m["name"] for m in spec.metrics_for(name, trace=False)}
        assert "setup_s" in mine and len(mine) >= 2
        traced = spec.metrics_for(name, trace=True)
        assert traced and all(m["moves"] in mine for m in traced)
