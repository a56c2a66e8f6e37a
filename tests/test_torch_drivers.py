"""The port's drivers (``scripts/*_torch.py``, ``run_local_torch.sh``) and
the JAX-free reference replica, on the CPU at small sizes.

* ``scripts/e2e_synthetic_torch.py``: its ``LearnableDS`` equals the JAX
  script's bit for bit (the JAX script trains at import, so its class is
  taken out with ``ast``); its recipe at depth 50, 2 steps, batch 2 of 65²
  crops of 64×128 images exports a ``.pth`` that the replica and
  ``ccnet_tpu.utils.load_pth(strict=True)`` both read, and from which the
  port's f32 model and the replica give the same whole-image logits;
* ``tests/_torch_reference_replica.TorchCCNet`` gives the logits of the
  original in ``tests/test_full_ccnet_torch_parity.py``, bit for bit;
* ``scripts/remat_scale_torch.py``: no remat and remat run, and remat does
  not change the first step's loss;
* ``scripts/probe_whole_batch_torch.py``: B = 2 gives B = 1's argmax;
* ``scripts/make_lists_torch.py`` writes ``scripts/make_lists.py``'s files,
  and ``run_local_torch.sh`` hands ``torchrun`` argument lists that the
  port's CLIs parse.
"""

import ast
import importlib
import importlib.util
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_lists import _touch, make_fake_cityscapes

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _script(name: str):
    """``scripts/<name>.py`` loaded as ``python scripts/<name>.py`` would."""
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_learnable_ds():
    """``LearnableDS`` of ``scripts/e2e_synthetic.py`` alone (the script
    trains at import)."""
    tree = ast.parse((SCRIPTS / "e2e_synthetic.py").read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "LearnableDS")
    ns = {"np": np}
    exec(compile(ast.Module(body=[cls], type_ignores=[]), "e2e_synthetic.py", "exec"), ns)
    return ns["LearnableDS"]


@pytest.mark.parametrize("kwargs", [{}, {"n": 2, "seed": 1000}, {"hw": (64, 128)}])
def test_learnable_ds_equals_jax_script(kwargs):
    ours = _script("e2e_synthetic_torch").LearnableDS(**kwargs)
    theirs = _jax_learnable_ds()(**kwargs)
    assert len(ours) == len(theirs)
    for i in (0, 1, len(ours) - 1):
        (a_img, a_lbl, a_name), (b_img, b_lbl, b_name) = ours[i], theirs[i]
        assert a_img.dtype == b_img.dtype and a_lbl.dtype == b_lbl.dtype
        assert np.array_equal(a_img, b_img) and np.array_equal(a_lbl, b_lbl)
        assert a_name == b_name


def test_replica_equals_original_torch_ccnet():
    from _torch_reference_replica import TorchCCNet as Replica
    from test_full_ccnet_torch_parity import TorchCCNet as Original

    layers, classes = (2, 1, 2, 1), 7
    torch.manual_seed(0)
    original = Original(classes, layers, 2)
    rng = np.random.RandomState(0)
    sd = {}
    for k, v in original.state_dict().items():  # BN stats, 1-D params and gamma matter
        if k.endswith("gamma"):
            v = torch.full_like(v, 0.5)
        elif k.endswith(("running_mean", "bias", "weight")) and v.dim() == 1:
            v = v + torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1)
        elif k.endswith("running_var"):
            v = torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + 0.5)
        sd[k] = v
    original.load_state_dict(sd)
    replica = Replica(classes, layers, 2)
    replica.load_state_dict(sd)
    assert list(replica.state_dict()) == list(original.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 65, 97).astype(np.float32))
    with torch.no_grad():
        got, want = replica.eval()(x), original.eval()(x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _replica_logits(pth, img):
    from _torch_reference_replica import TorchCCNet

    tm = TorchCCNet(19, (3, 4, 6, 3), 2)
    load = tm.load_state_dict(torch.load(pth, weights_only=False), strict=False)
    assert not load.unexpected_keys, load.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in load.missing_keys)
    with torch.no_grad():
        return tm.eval()(img)[0].numpy()


def test_e2e_recipe_small_on_cpu(tmp_path):
    from ccnet_tpu.models import CCNet as JaxCCNet
    from ccnet_tpu.utils import load_pth as jax_load_pth
    from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    e2e = _script("e2e_synthetic_torch")
    r = e2e.run(depth=50, steps=2, batch=2, crop=65, hw=(64, 128), device="cpu",
                snap_dir=str(tmp_path / "snap"))
    assert len(r["losses"]) == 2 and all(math.isfinite(v) for v in r["losses"])
    assert not any(r["train_launches"].values()) and not any(r["eval_launches"].values())
    assert 0.0 <= r["port_miou"] <= 1.0 and 0.0 <= r["replica_miou"] <= 1.0
    assert 0.0 <= r["agreement"] <= 1.0 and r["gamma_port"] == r["gamma_replica"]
    pth = r["pth"]
    assert pth == str(tmp_path / "snap" / "CS_scenes_2.pth")

    # the JAX package reads the port's .pth strictly
    jm = JaxCCNet(num_classes=19, layers=(3, 4, 6, 3), recurrence=2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                                            train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    _, miss, unexp = jax_load_pth(pth, template, strict=True)
    assert not miss and not unexp

    # the port's f32 model and the replica: the same whole-image logits
    img, _, _ = e2e.LearnableDS(n=1, hw=(64, 128), seed=1000)[0]
    x = torch.from_numpy(
        (img - np.asarray(CITYSCAPES_MEAN_BGR, np.float32)).transpose(2, 0, 1)[None].copy())
    model = build_model("ccnet", num_classes=19, depth=50, dtype=torch.float32)
    load_pth(pth, model, strict=True)
    with torch.no_grad():
        ours = model(x)["main"].numpy()
    theirs = _replica_logits(pth, x)
    assert ours.shape == theirs.shape == (1, 19, 9, 17)
    scale = max(np.abs(theirs).max(), 1.0)
    assert np.abs(ours - theirs).max() <= 1e-4 * scale


def test_remat_scale_modes_agree_on_cpu():
    remat = _script("remat_scale_torch")
    runs = {m: remat.try_mode(m, 1, (65, 65), device="cpu", depth=50, steps=1)
            for m in ("False", "True")}
    assert all(r["ok"] and not r["oom"] and r["s_per_step"] > 0 for r in runs.values())
    a, b = runs["False"]["first_loss"], runs["True"]["first_loss"]
    assert math.isfinite(a) and abs(a - b) <= 1e-6 * abs(a)


def test_whole_batch_argmax_equal_on_cpu():
    r = _script("probe_whole_batch_torch").probe("cpu", depth=50, hw=(64, 128),
                                                 batches=(1, 2), reps=1)
    assert set(r["batches"]) == {1, 2}
    assert r["batches"][2]["agreement"] == [1.0] * 2  # the largest B's count of images
    assert r["batches"][1]["forwards"] == 3 and r["batches"][2]["forwards"] == 2


def _voc_tree(root):
    ids = [f"2007_{i:06d}" for i in (3, 0, 7, 1, 5, 2, 6, 4)]
    for i in ids:
        _touch(os.path.join(root, "SegmentationClassAug", f"{i}.png"))
    os.makedirs(os.path.join(root, "ImageSets", "Segmentation"))
    with open(os.path.join(root, "ImageSets", "Segmentation", "val.txt"), "w") as f:
        f.write("\n".join(ids[5:]) + "\n")


def _files(out):
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(out).iterdir())}


@pytest.mark.parametrize("dataset", ["cityscapes", "voc"])
def test_make_lists_torch_equals_jax_script(tmp_path, capsys, dataset):
    root = str(tmp_path / "data")
    make_fake_cityscapes(root) if dataset == "cityscapes" else _voc_tree(root)
    _script("make_lists_torch").main([dataset, root, str(tmp_path / "port")])
    ours = capsys.readouterr().out
    _script("make_lists").main([dataset, root, str(tmp_path / "jax")])
    assert ours == capsys.readouterr().out and ours
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_run_local_torch_sh_parses(tmp_path):
    script = REPO / "run_local_torch.sh"
    subprocess.run(["bash", "-n", str(script)], check=True, timeout=60)
    stub, log = tmp_path / "bin", tmp_path / "argv.log"
    stub.mkdir()
    (stub / "torchrun").write_text(
        '#!/usr/bin/env bash\nfor a in "$@"; do printf "%s\\n" "$a"; done >> "$TORCHRUN_LOG"\n'
        'echo "--end--" >> "$TORCHRUN_LOG"\n')
    (stub / "torchrun").chmod(0o755)
    env = {**os.environ, "PATH": f"{stub}{os.pathsep}{os.environ['PATH']}",
           "TORCHRUN_LOG": str(log), "LR": "5e-3", "WD": "5e-4", "BS": "4",
           "SNAPSHOT_DIR": str(tmp_path / "snap"), "RESTORE_FROM": "init.pth",
           "CUDA_VISIBLE_DEVICES": ""}
    subprocess.run(["bash", str(script), "/data/cs", "pspnet", "12", "65,65", "0"],
                   check=True, env=env, cwd=tmp_path, timeout=120)
    calls = [c.strip("\n").split("\n") for c in log.read_text().split("--end--\n") if c]
    assert [c[:5] for c in calls] == [
        ["--standalone", "--nproc_per_node", "1", "-m", f"ccnet_tpu_torch.cli.{m}"]
        for m in ("train", "evaluate")]
    parsed = [importlib.import_module(c[4]).get_parser().parse_args(c[5:]) for c in calls]
    train, evaluate = parsed
    assert (train.data_dir, train.model, train.num_steps, train.input_size, train.ohem,
            train.batch_size, train.learning_rate, train.weight_decay, train.restore_from) == (
        "/data/cs", "pspnet", 12, "65,65", False, 4, 5e-3, 5e-4, "init.pth")
    assert train.snapshot_dir == str(tmp_path / "snap")
    assert (evaluate.data_dir, evaluate.model, evaluate.input_size, evaluate.restore_from) == (
        "/data/cs", "pspnet", "65,65", str(tmp_path / "snap" / "CS_scenes_12.pth"))
