"""BENCHMARK.json against the benchmark's contract, and every cell's files
found and its INI read by the port's own loader."""

import configparser
import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and BENCH["command"][1] == "benchmark/run.py"
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32


def test_names_and_units_meet_the_character_rule():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer"):
                if key in entry:
                    assert _line(entry[key]), (entry["name"], key)
            if group == "configs":
                assert _line(entry["source"])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s", "site_updates_per_s"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["better"] in ("lower", "higher")


def test_every_config_is_used_and_every_cell_reports_a_layer():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    mod = importlib.import_module(f"benchmark.metrics.{metric}")
    assert callable(mod.read)
    for target, name, kind in mod.RANGES:
        assert kind in ("call", "iter") and NAME.match(name)
        obj, attr = harness.resolve(target)
        assert callable(getattr(obj, attr))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_and_its_ini_read_by_the_port(cell, tmp_path):
    from cmdlmc_tpu_torch.config.schema import load_config

    spec = harness.load_spec(cell, ROOT)
    parser = configparser.ConfigParser()
    parser.optionxform = str
    parser.read_dict(harness.ini_sections(spec, 2**31 + 3, tmp_path / "t.xyz", tmp_path))
    ini = tmp_path / "run.ini"
    with open(ini, "w") as f:
        parser.write(f)
    cfg = load_config(str(ini))
    phys = harness.physics(harness.ini_sections(spec, 2**31 + 3, tmp_path / "t.xyz", tmp_path))
    # the harness reads the physics as the port's loader does
    topo, e, o = cfg.topology, cfg.engine, cfg.output
    assert phys["box"] == tuple(float(x) for x in cfg.atombox.periodic_boundaries)
    assert phys["mult"] == tuple(int(m) for m in cfg.atombox.box_multiplier)
    assert phys["law"] == {"a": cfg.jumprate.a, "b": cfg.jumprate.b, "c": cfg.jumprate.c}
    assert (phys["cutoff"], phys["buffer"], phys["k"]) == (
        topo.cutoff, topo.buffer, int(topo.max_neighbors or 0))
    assert phys["dt"] == float(cfg.kmc.time_step or cfg.trajectory.time_step)
    assert (phys["max_events"], phys["block"], phys["eq"], phys["tile"]) == (
        e.max_events_per_frame, e.block_size, e.equilibration_sweeps, e.tile)
    assert (phys["print_freq"], phys["reset_freq"], phys["nbins"]) == (
        o.print_frequency, o.reset_frequency, o.jumpstat_bins)
    assert phys["hist_range"] == tuple(float(x) for x in o.jumpstat_range)
    assert phys["matrix"] == bool(e.jumpmatrix_filename)
    assert phys["protons"] == cfg.kmc.proton_number
    conf = spec["config_spec"]
    m = conf["multiplier"]
    assert cfg.kmc.lattice_size == conf["cell_sites"] * m[0] * m[1] * m[2]
    assert phys["replicas"] == spec["traffic_spec"]["replicas"]
    assert phys["seed"] == 2**31 + 3 and cfg.trajectory.repeat
    assert set(spec["limits"]) >= {"positions", "init", "far_partings", "rows"}
