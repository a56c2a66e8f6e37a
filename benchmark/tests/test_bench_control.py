"""The comparison that decides ``correct``, shown to fail where it must.

On the CPU, at a size a test run holds (the trunk one block a layer, 65²
crops, a batch of 4), with the program in f32 and limits for that size:

* the control, the reference in the program's place computed in float8
  (:func:`benchmark.reference.models.precision`), reads above a sound run
  of the program;
* a run drives everything but the card check with the timed path broken
  underneath, once for each fault its cell can have (a training step that
  returns its state unchanged, or that leaves half of the batch out; a
  served answer altered where it is produced), and ``correct`` comes out
  false, where the same run unbroken comes out true.

``test_control_fails_at_cell_size`` reads the control at the cells' own
sizes against their real limits; it needs a card.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, harness, run

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _tiny  # noqa: E402

TRAIN = {"loss_gap": 0.005, "grad_gap": 0.01, "change_gap": 0.05, "crop_gap": 0.01,
         "label_miss": 0.01}
TINY_LIMITS = {
    "ccnet_r101.train769": TRAIN,
    "ccnet_r101.train769_syncbn4": TRAIN,
    "ccnet_r101.serve_sliding": {"id_gap": 0.1},
}


def _root(tmp_path, monkeypatch):
    root = _tiny.tiny_root(tmp_path)
    _tiny.tiny_port(monkeypatch)
    here = os.path.join(root, "benchmark")
    for name in os.listdir(os.path.join(here, "configs")):
        _tiny._edit(os.path.join(here, "configs", name), dtype="float32")
    _tiny._edit(os.path.join(here, "traffic", "train769.json"), batch=4)
    _tiny._edit(os.path.join(here, "traffic", "train769_syncbn4.json"), batch=4)
    for cell, limits in TINY_LIMITS.items():
        with open(os.path.join(here, "limits", f"{cell}.json"), "w") as f:
            json.dump(limits, f)
    return root


def _run(root, cell, capsys) -> dict:
    code = run.main(["--workload", cell, "--seed", str(2 ** 31 + 99), "--seconds", "0.3"],
                    device="cpu", root=root)
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _unchanged(real):
    def make(criterion, seed=0, forward=None):
        def step(state, images, labels):
            with torch.no_grad():
                loss = criterion(state.model.train()(images), labels)
            state.step += 1
            return {"loss": loss}
        return step
    return make


def _half_batch(real):
    def make(criterion, seed=0, forward=None):
        step = real(criterion, seed=seed, forward=forward)

        def half(state, images, labels):
            n = images.shape[0] // 2
            return step(state, images[:n], labels[:n])
        return half
    return make


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_train_faults_fail(tmp_path, monkeypatch, capsys, fault):
    root = _root(tmp_path, monkeypatch)
    if fault:
        from ccnet_tpu_torch.train import trainer

        plant = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
        monkeypatch.setattr(trainer, "make_train_step", plant(trainer.make_train_step))
    out = _run(root, "ccnet_r101.train769", capsys)
    assert out["correct"] is (fault is None), out["compared"]


@pytest.mark.parametrize("fault", [None, "altered"])
def test_serve_faults_fail(tmp_path, monkeypatch, capsys, fault):
    root = _root(tmp_path, monkeypatch)
    if fault:
        from ccnet_tpu_torch.evaluation import evaluator

        real = evaluator.Evaluator.predict_batch

        def altered(self, images):
            ids = real(self, images)
            ids[:, :16, :16] = (ids[:, :16, :16] + 1) % 19
            return ids
        monkeypatch.setattr(evaluator.Evaluator, "predict_batch", altered)
    out = _run(root, "ccnet_r101.serve_sliding", capsys)
    assert out["correct"] is (fault is None), out["compared"]


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_ranks_exchange_left_out_fails(tmp_path, monkeypatch, capsys, fault):
    """The multi-card cell over 2 gloo ranks (2 crops each): with every
    collective of the program left out, ``correct`` comes out false."""
    from benchmark.tests import _rank

    root = _root(tmp_path, monkeypatch)
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for w in bench["workloads"]:
        if w["name"] == "ccnet_r101.train769_syncbn4":
            w["chips"] = 2
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    argv = ["--workload", "ccnet_r101.train769_syncbn4", "--seed", "17", "--seconds", "0.3"]
    env = dict(os.environ, OMP_NUM_THREADS="2")

    def spawn(args, ranks):
        return [subprocess.Popen([sys.executable, _rank.__file__, root, str(r), str(args.port),
                                  fault, *argv], env=env) for r in range(1, ranks)]

    monkeypatch.setattr(run, "_spawn_ranks", spawn)
    _rank.plant(monkeypatch, fault)
    assert run.main(argv, device="cpu", root=root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is (fault == "none"), out["compared"]


def test_control_reads_above_the_program(tmp_path, monkeypatch, capsys):
    root = _root(tmp_path, monkeypatch)
    program = _run(root, "ccnet_r101.train769", capsys)["compared"]
    cell = harness.find_cell("ccnet_r101.train769", root)
    got = calibrate._train_variants(cell, 2 ** 31 + 99, torch.device("cpu"), cell.driver())
    control = got["control_fp8"]
    assert any(control[k] > TINY_LIMITS[cell.name][k] for k in ("loss_gap", "grad_gap"))
    assert control["grad_gap"] > 3 * program["grad_gap"]["value"]
    for fault in ("half_batch", "mirror"):
        assert any(got[fault][k] > v for k, v in TINY_LIMITS[cell.name].items()), fault


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ccnet_r101.train769", "deeplabv3_r101.train769",
                                  "ccnet_r101.serve_sliding"])
def test_control_fails_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = harness.find_cell(name)
    variants = (calibrate._train_variants if cell.traffic["driver"] == "train"
                else calibrate._serve_variants)
    got = variants(cell, 2 ** 31 + 1234, torch.device("cuda:0"), cell.driver())
    control = got["control_fp8"]
    if isinstance(control, dict):
        assert any(control[k] > limit for k, limit in cell.limits.items())
    else:
        assert control > cell.limits["id_gap"]
