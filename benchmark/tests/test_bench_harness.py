"""The harness on the CPU: cells found by name, new files picked up without an
edit, the result line's keys, the p95, no card, no JAX."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness, run, trace
from benchmark.drivers import serve

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _tiny  # noqa: E402

REPO = harness.ROOT


def _bench():
    return harness.load_json(os.path.join(REPO, "BENCHMARK.json"))


def test_every_cell_has_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.driver().run
        assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "benchmark", "metrics", f"{m['name']}.py"))
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("trace_on", [0, 1])
def test_result_line_keys(tmp_path, monkeypatch, capsys, trace_on):
    root = _tiny.tiny_root(tmp_path)
    _tiny.tiny_port(monkeypatch)
    code = run.main(["--workload", "ccnet_r101.train769", "--seed", str(2 ** 31 + 5),
                     "--seconds", "0.5", "--trace", str(trace_on)], device="cpu", root=root)
    assert code == 0
    out = _last_json(capsys.readouterr().out)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "compared"] if trace_on else ["compared"]
    assert list(out) == keys
    assert set(out["compared"]) == set(harness.find_cell("ccnet_r101.train769").limits)
    if trace_on:
        assert "mfu.train" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_crops_per_s", "setup_s", "peak_mem_gib"}


def test_new_config_traffic_and_metric_are_files(tmp_path, monkeypatch, capsys):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    new files plus BENCHMARK.json entries run with no other file edited."""
    root = _tiny.tiny_root(tmp_path)
    _tiny.tiny_port(monkeypatch)
    here = os.path.join(root, "benchmark")
    before = {p: open(os.path.join(here, p), "rb").read()
              for p in ("drivers/train.py", "harness.py", "run.py")}
    shutil.copy(os.path.join(here, "configs", "ccnet_r101_cityscapes.json"),
                os.path.join(here, "configs", "ccnet_r101_r1.json"))
    _tiny._edit(os.path.join(here, "configs", "ccnet_r101_r1.json"), recurrence=1)
    shutil.copy(os.path.join(here, "traffic", "train769.json"),
                os.path.join(here, "traffic", "train_b4.json"))
    _tiny._edit(os.path.join(here, "traffic", "train_b4.json"), batch=4)
    shutil.copy(os.path.join(here, "limits", "ccnet_r101.train769.json"),
                os.path.join(here, "limits", "ccnet_r1.train_b4.json"))
    with open(os.path.join(here, "metrics", "steps_traced.train.py"), "w") as f:
        f.write("def read(t):\n    return float(t.steps)\n")
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "ccnet_r101_r1", "source": "https://arxiv.org/abs/1811.11721",
                             "file": "benchmark/configs/ccnet_r101_r1.json",
                             "reduced": ["recurrence"], "why": "one recurrence"})
    bench["workloads"].append({"name": "ccnet_r1.train_b4", "config": "ccnet_r101_r1",
                               "traffic": "train_b4", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "ccnet_r101.train769" in m["workloads"]:
            m["workloads"].append("ccnet_r1.train_b4")
    bench["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_crops_per_s", "workloads": ["ccnet_r1.train_b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.find_cell("ccnet_r1.train_b4", root)
    assert cell.config["recurrence"] == 1 and cell.traffic["batch"] == 4
    code = run.main(["--workload", "ccnet_r1.train_b4", "--seed", "7", "--seconds", "0.5",
                     "--trace", "1"], device="cpu", root=root)
    assert code == 0
    out = _last_json(capsys.readouterr().out)
    assert out["metrics"]["steps_traced.train"]["value"] == cell.traffic["trace_steps"]
    assert all(open(os.path.join(here, p), "rb").read() == b for p, b in before.items())


# an FCN head: a 3x3 reduction to 256 channels, dropout on them, the classifier
FCN_HEAD = """
import torch
from benchmark.reference.models import ABN, Conv2d, MaskedDropout, Seq


def head(config: dict) -> torch.nn.Module:
    return Seq(Conv2d(2048, 256, 3, padding=1, bias=False), ABN(256),
               MaskedDropout(config.get("dropout", 0.1), 256),
               Conv2d(256, config["num_classes"], 1, bias=True))
"""

NEW_MODEL_RUN = """
import json, os, sys
sys.path.insert(0, os.getcwd())
from benchmark import harness, inputs
from benchmark.reference import models, train
from benchmark.work import flops
cell = harness.find_cell("fcn_r101.train769", os.getcwd())
count, shape = flops.forward_flops(cell.config, 2, (65, 65))
net = models.build(cell.config)
masks = [None] * len(net.dropouts())
for i, mod in enumerate(net.dropouts()):
    mod.register_forward_pre_hook(lambda m, a, i=i: masks.__setitem__(i, list(m.mask.shape)))
tr = cell.traffic
frames, labels = inputs.frames(3, tr["pool"], tr["frame_hw"], 19, 255, tr["block"],
                               tr["border"], tr["noise"], "cpu")
models.load(net, inputs.weights(models.state_names(net), 3, "cpu"))
got = train.train_steps(net, frames, labels, [[0, 1]], cell.config, tr, 3, 1)
print(json.dumps({"file": models.__file__, "flops": count, "shape": shape, "masks": masks,
                  "losses": got["losses"]}))
"""


def test_new_model_is_new_files(tmp_path):
    """A model the reference did not know, added as a head file, a
    configuration naming it and BENCHMARK.json entries: the harness finds
    its cell, and the reference builds it, counts its FLOPs and trains it,
    drawing its head's dropout masks at the head's own 256 channels, with
    no file that was there edited."""
    root = _tiny.tiny_root(tmp_path)
    here = os.path.join(root, "benchmark")
    before = {}
    for folder, _, files in os.walk(root):
        for name in files:
            path = os.path.join(folder, name)
            before[path] = open(path, "rb").read()
    with open(os.path.join(here, "reference", "heads", "fcn.py"), "w") as f:
        f.write(FCN_HEAD)
    config = harness.load_json(os.path.join(here, "configs", "deeplabv3_r101_cityscapes.json"))
    del config["aspp"]
    config.update(name="fcn_r101", model="fcn")
    with open(os.path.join(here, "configs", "fcn_r101.json"), "w") as f:
        json.dump(config, f)
    shutil.copy(os.path.join(here, "limits", "deeplabv3_r101.train769.json"),
                os.path.join(here, "limits", "fcn_r101.train769.json"))
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "fcn_r101", "source": "https://arxiv.org/abs/1411.4038",
                             "file": "benchmark/configs/fcn_r101.json", "reduced": [],
                             "why": "a test model"})
    bench["workloads"].append({"name": "fcn_r101.train769", "config": "fcn_r101",
                               "traffic": "train769", "chips": 1, "why": "a test cell"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", NEW_MODEL_RUN], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = _last_json(proc.stdout)
    assert out["file"] == os.path.join(here, "reference", "models.py")
    assert out["flops"] > 0 and out["shape"] == [2, 19, 9, 9]
    assert out["masks"] == [[2, 512, 9, 9], [2, 256, 9, 9]]  # the DSN's, then the head's
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    for path, data in before.items():
        if path != os.path.join(root, "BENCHMARK.json"):
            assert open(path, "rb").read() == data, path


def test_p95_is_over_every_request():
    lat = [0.05] * 90 + [0.5] * 10
    assert serve.p95_ms(lat) == pytest.approx(1e3 * np.percentile(lat, 95))
    assert serve.p95_ms(lat) == pytest.approx(500.0)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "benchmark", "run.py"),
                           "--workload", "ccnet_r101.train769", "--seed", "1", "--seconds", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files exits
    non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "sys.exit(run.main(['--workload', 'ccnet_r101.train769', '--seed', '1', "
            "'--seconds', '1'], device='cpu', root='.'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "ccnet_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


def test_forbidden_names_compare_whole():
    names = ["ccnet_tpu_torch", "ccnet_tpu_torch.ops", "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["ccnet_tpu.models", "jax"]) == [
        "ccnet_tpu.models", "jax"]


def test_nothing_run_imports_jax():
    """Importing every module a run or the calibration imports leaves no
    module of JAX or of the JAX package loaded."""
    code = """
import sys, os, glob, importlib.util
sys.path.insert(0, os.getcwd())
from benchmark import harness, run, calibrate, inputs, trace
from benchmark.reference import models, train, serve
from benchmark.work import flops, ops, peaks
import ccnet_tpu_torch.train.trainer, ccnet_tpu_torch.evaluation, ccnet_tpu_torch.models
for w in harness.load_json("BENCHMARK.json")["workloads"]:
    harness.find_cell(w["name"]).driver()
for path in glob.glob("benchmark/metrics/*.py"):
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(harness.forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


class _Ev:
    def __init__(self, name, kind, start, dur, thread=1, corr=0, linked=0):
        self._v = (name, kind, start, dur, thread, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def test_stretch_reduction():
    """Busy time is the union of device intervals in the profiled steps;
    kernels are credited to the host range they were launched from; the
    longest gap is named by the innermost host range over it."""
    events = [
        _Ev("ProfilerStep#3", "CPU", 0, 1000),
        _Ev("ProfilerStep#4", "CPU", 1000, 1000),
        _Ev("CrissCrossAttentionFn", "CPU", 100, 100),
        _Ev("cudaLaunchKernel", "CPU", 120, 5, corr=7),
        _Ev("aten::copy_", "CPU", 400, 500),
        _Ev("cudaLaunchKernel", "CPU", 410, 5, corr=8),
        _Ev("CrissCrossAttentionFnBackward", "CPU", 1100, 100, thread=2),
        _Ev("cudaLaunchKernel", "CPU", 1150, 5, thread=2, corr=9),
        _Ev("cca_fwd_tc_kernel", "CUDA", 150, 200, linked=7),
        _Ev("nchwToNhwcKernel", "CUDA", 300, 100, linked=8),
        _Ev("cca_bwd_tc_kernel", "CUDA", 1200, 300, linked=9),
        _Ev("late", "CUDA", 1900, 500),
        _Ev("ProfilerStep#3", "CUDA", 0, 1000),
    ]
    s = trace.reduce(events, 2, {"kind": "train"})
    assert s.window_s == pytest.approx(2000e-9)
    assert s.busy_s == pytest.approx((250 + 300 + 100) * 1e-9)
    assert s.device_s_within("CrissCrossAttentionFn") == pytest.approx(500e-9)
    assert s.device_s(("nchwToNhwc",)) == pytest.approx(100e-9)
    assert s.idle_gaps(1) == [["aten::copy_", pytest.approx(800e-9)]]
    assert s.top_ops(1) == [["cca_bwd_tc_kernel", pytest.approx(300e-9)]]
    assert s.idle_gaps(2)[1] == ["host between aten::copy_ and end", pytest.approx(400e-9)]
