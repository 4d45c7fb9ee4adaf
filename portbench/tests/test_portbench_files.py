"""Every file is found by name, BENCHMARK.json keeps to the contract's
shape, and a configuration, a traffic mix, a cell and a metric can be
added as new files plus entries with no existing file edited."""

import json
import os
import re

from conftest import ROOT, copy_bench

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in s[k]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in s["end_to_end"]}
    assert {"reads_per_s", "setup_s"} <= e2e
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cfgs = {c["name"] for c in s["configs"]}
    for w in s["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in cfgs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(s)) < 64 * 1024


def test_every_file_loads_by_name():
    s = spec()
    for w in s["workloads"]:
        c = bench.load_cell(w["name"], ROOT)
        assert c.config["name"] == w["config"]
        assert set(c.limits["limits"]) >= {"tag_bad", "over_best",
                                           "pair_bad", "pair_lost",
                                           "rescue_bad", "short_share"}
        for key in ("read_length", "check_sample"):
            assert key in c.traffic
        for trace in (False, True):
            for name in bench.metric_names(c, trace):
                assert callable(bench.load_reader(c.bench, name))
    for c in s["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for k in c["reduced"]:
            assert k in cfg and k in cfg["published"]


def test_scoring_of_each_configuration_is_the_programs():
    """The configuration's flags, parsed by the program's own CLI parser,
    give the scoring its `guarantees` state."""
    from bwamem2_tpu_torch.cli import parse_mem_args
    want = {"sr_chr1": (1, 4, 6, 1, 5)}
    for name, sc in want.items():
        with open(os.path.join(ROOT, "portbench", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        opt, mode = parse_mem_args(cfg["mem_args"] + ["x", "y"])[:2]
        opt.finalize(mode)
        assert (opt.a, opt.b, opt.o_del, opt.e_del, opt.pen_clip5) == sc
        assert (opt.o_ins, opt.e_ins) == (opt.o_del, opt.e_del)


def test_added_files_are_found_without_an_edit(tmp_path):
    root = copy_bench(str(tmp_path))
    b = os.path.join(root, "portbench")
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(b) for p in fs}
    with open(os.path.join(b, "configs", "sr_chr1.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "sr_new"
    with open(os.path.join(b, "configs", "sr_new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "pe150.json")) as f:
        tr = json.load(f)
    tr["read_length"] = 250
    with open(os.path.join(b, "traffic", "pe250.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(b, "cells", "sr_new.pe250.json"), "w") as f:
        json.dump({"limits": {"tag_bad": 0}}, f)
    with open(os.path.join(b, "metrics", "new.reads_x2.py"), "w") as f:
        f.write("def read(w):\n    return 2 * w.reads\n")
    s = spec()
    s["configs"].append({"name": "sr_new", "source": "x", "reduced": [],
                         "file": "portbench/configs/sr_new.json",
                         "why": "x"})
    s["workloads"].append({"name": "sr_new.pe250", "config": "sr_new",
                           "traffic": "pe250", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "new.reads_x2", "unit": "reads",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "reads_per_s",
                           "workloads": ["sr_new.pe250"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    c = bench.load_cell("sr_new.pe250", root)
    assert c.traffic["read_length"] == 250 and c.config["name"] == "sr_new"
    names = bench.metric_names(c, True)
    assert "new.reads_x2" in names
    assert "new.reads_x2" not in bench.metric_names(
        bench.load_cell("sr_chr1.pe150", root), True)

    class W:
        reads = 21
    assert bench.load_reader(c.bench, "new.reads_x2")(W()) == 42
    for p, data in before.items():
        hits = [os.path.join(dp, p) for dp, _, fs in os.walk(b) if p in fs]
        assert any(open(h, "rb").read() == data for h in hits)
