"""A configuration, a traffic mix, a per-layer metric and a model are added
as new files and new entries, in a copy of the benchmark, and the harness
finds them without an edit to any existing file."""

import hashlib
import json
import shutil
from pathlib import Path

from benchmark import judge, tracing
from benchmark.reference import train as rtrain
from benchmark.registry import DEFAULT_MODEL, Registry
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _with_new_files(tmp_path: Path):
    """A copy of the benchmark with new files and entries: a configuration,
    a serving mix, a metric; and a second model (``f0_linear_model.py``,
    with the leaf ``f0_in`` that ``ddsp_decoder`` lacks), a configuration
    that names it, a training mix, limits and a cell.  Returns (registry,
    the copy's digests before)."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _digests(bench)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny_fields = json.loads((bench / "configs" / "ddsp44k_tiny.json").read_text())

    (bench / "configs" / "ddsp16k_solo.json").write_text(json.dumps(
        dict(tiny_fields, sample_rate=16000, n_harmonics=60, n_noise_filters=65)))
    (bench / "workloads" / "serve_n8.json").write_text(json.dumps(
        dict(json.loads((bench / "workloads" / "serve_n128.json").read_text()), slots=8)))
    (bench / "metrics" / "copies_ms.serve.py").write_text(
        "def read(w):\n    return w.per_unit_ms('copies') if 'copies' in w.device_s else None\n")
    spec["configs"].append({"name": "ddsp16k_solo", "source": "https://example.org/solo",
                            "file": "benchmark/configs/ddsp16k_solo.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "serve_solo_n8", "config": "ddsp16k_solo",
                              "traffic": "serve_n8", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("serve_solo_n8")
    spec["per_layer"].append({"name": "copies_ms.serve", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "serving wrapper",
                              "moves": "serve_streams_rt"})

    shutil.copy(HERE / "f0_linear_model.py", bench / "models" / "ddsp_f0lin.py")
    (bench / "configs" / "ddsp44k_f0lin.json").write_text(json.dumps(
        dict(tiny_fields, model="ddsp_f0lin")))
    (bench / "workloads" / "train_b4.json").write_text(json.dumps(tiny.TRAIN_MIX))
    shutil.copy(bench / "limits" / "train_tiny_b384.json", bench / "limits" / "train_f0lin_b4.json")
    spec["configs"].append({"name": "ddsp44k_f0lin", "source": "https://example.org/f0lin",
                            "file": "benchmark/configs/ddsp44k_f0lin.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "train_f0lin_b4", "config": "ddsp44k_f0lin",
                              "traffic": "train_b4", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("train_"):
            m["workloads"].append("train_f0lin_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(tmp_path, bench), before


def _drive_f0lin(reg: Registry):
    """The second model's cell on the CPU at narrow widths, judged by its
    limits: (correct, rows, the run's context)."""
    cell = reg.cell("train_f0lin_b4")
    ctx = tiny.cpu_context(reg.traffic(cell["traffic"]), model=reg.config_model(cell["config"]))
    res = tiny.drive(ctx)
    assert res["attempted"] > 0
    return (*judge.verdict(res["numbers"], reg.limits(cell["name"])), ctx)


def test_new_files_are_found_by_name(tmp_path):
    reg, before = _with_new_files(tmp_path)
    bench = tmp_path / "benchmark"
    listing = reg.listing()
    assert "ddsp16k_solo" in listing["configs"]
    assert "serve_n8" in listing["workloads"]
    assert "copies_ms.serve" in listing["metrics"]
    cell = reg.cell("serve_solo_n8")
    assert reg.config(cell["config"])["n_harmonics"] == 60
    assert reg.traffic(cell["traffic"])["slots"] == 8
    assert "serve_hop_ms_p95" in reg.end_to_end("serve_solo_n8")
    # a metric without a list of cells is read in every cell reporting its
    # end-to-end metric, and only there
    assert "copies_ms.serve" in [m["name"] for m in reg.per_layer("serve_solo_n8")]
    assert "copies_ms.serve" not in [m["name"] for m in reg.per_layer("train_tiny_b384")]
    window = tracing.Window(window_s=1.0, busy_s=0.5, units=10, n_ops=100,
                            device_s={"copies": 0.02})
    assert reg.reader("copies_ms.serve")(window) == 2.0
    assert reg.reader("copies_ms.serve")(tracing.Window(1.0, 0.5, 10, 100)) is None

    # the second model, found through its configuration, the others'
    # model the default; its cell driven and judged correct
    assert listing["models"] == [DEFAULT_MODEL, "ddsp_f0lin"]
    assert reg.config_model("ddsp16k_solo") is reg.model(DEFAULT_MODEL)
    model = reg.config_model("ddsp44k_f0lin")
    assert model is reg.model("ddsp_f0lin")
    assert model.config(reg.config("ddsp44k_f0lin")).n_harmonics == 180
    ok, rows, ctx = _drive_f0lin(reg)
    assert ok, rows
    assert {"f0_in.weight", "f0_in.bias"} <= set(model.train_inputs(ctx).start)

    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_new_model_with_a_faulted_reference_is_refused(tmp_path, monkeypatch):
    """The second model's reference leaving out its extra leaf (the plain
    decoder's loss): the judge refuses the run."""
    reg, _ = _with_new_files(tmp_path)
    monkeypatch.setattr(reg.model("ddsp_f0lin"), "block_loss", rtrain.block_loss)
    ok, rows, _ = _drive_f0lin(reg)
    assert not ok, rows


def test_every_cell_finds_its_parts():
    reg = Registry(ROOT)
    listing = reg.listing()
    for cell in reg.spec["workloads"]:
        assert reg.config(cell["config"])
        assert reg.config(cell["config"]).get("model", DEFAULT_MODEL) in listing["models"]
        assert cell["traffic"] in listing["workloads"]
        assert reg.limits(cell["name"]), cell["name"]
        for m in reg.per_layer(cell["name"]):
            assert m["name"] in listing["metrics"]
            assert reg.unit(m["name"]) == m["unit"]
