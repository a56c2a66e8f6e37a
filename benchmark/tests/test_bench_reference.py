"""The benchmark's plain reference held to the port at small sizes on the CPU.

The reference shares no code with the program; these tests show that the
two compute the same function where the arithmetic is the same (f32 on the
CPU): the networks, the criterion, the SGD step, the augmentation and the
dropout masks drawn by the program's rule.
"""

import ast
import os

import pytest
import torch

from benchmark import inputs
from benchmark.reference import models as R
from benchmark.reference import train as RT

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "reference")
LAYERS = (1, 1, 1, 1)


def _config(model):
    return {"model": model, "num_classes": 19, "layers": list(LAYERS), "recurrence": 2,
            "dropout": 0.1, "ignore_label": 255}


@pytest.fixture
def tiny_port(monkeypatch):
    from ccnet_tpu_torch.models import registry

    monkeypatch.setitem(registry._DEPTH_LAYERS, 101, LAYERS)


def _pair(model, seed=3):
    from ccnet_tpu_torch.models import build_model

    port = build_model(model, depth=101, dtype=torch.float32, impl="torch")
    shapes = [(n, tuple(t.shape)) for n, t in port.state_dict().items()]
    weights = inputs.weights(shapes, seed, "cpu")
    port.load_state_dict(weights)
    ref = R.build(_config(model))
    R.load(ref, weights)
    return port, ref


@pytest.mark.parametrize("model", ["ccnet", "deeplabv3"])
@pytest.mark.parametrize("train", [False, True])
def test_network_matches_port(tiny_port, model, train):
    port, ref = _pair(model)
    x = torch.randn(2, 3, 65, 65, generator=torch.Generator().manual_seed(1)) * 40
    if train:
        port.train()
        ref.train()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed((5 + 2) * 1000003)  # the train step's rule, seed 5, step 0
            out = port(x)
        masks = RT.dropout_masks(5, 0, [(2, 512, 9, 9)] * 2, torch.float32, 0.1, "cpu")
        for mod, m in zip(ref.dropouts(), masks):
            mod.mask = m
    else:
        out = port(x)
    main, aux = ref(x)
    scale = main.abs().max()
    assert (out["main"] - main).abs().max() <= 1e-5 * scale
    assert (out["aux"] - aux).abs().max() <= 1e-5 * aux.abs().max()


def test_dropout_masks_follow_program_rule(tiny_port):
    """The masks the reference draws are the ones the program's train step
    draws for step ``s`` of seed ``seed``."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.nn.layers import Dropout
    from ccnet_tpu_torch.train import create_train_state, make_train_step

    seed = 41
    model = build_model("ccnet", depth=101, dtype=torch.float32, impl="torch")
    seen = []
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    state = create_train_state(model)
    step = make_train_step(build_criterion(ohem=True, impl="torch"), seed=seed + 2)
    x = torch.randn(2, 3, 65, 65) * 40
    step(state, x, torch.randint(0, 19, (2, 65, 65), dtype=torch.int32))
    masks = RT.dropout_masks(seed, 0, [i.shape for i, _ in seen], torch.float32, 0.1, "cpu")
    for (i, o), m in zip(seen, masks):
        assert torch.equal(o != 0, m | (i == 0))


@pytest.mark.parametrize("min_kept", [100, 100000])
def test_criterion_matches_port(min_kept):
    from ccnet_tpu_torch.losses import criterion_ohem_dsn

    g = torch.Generator().manual_seed(5)
    main = torch.randn(2, 19, 9, 9, generator=g, requires_grad=True)
    aux = torch.randn(2, 19, 9, 9, generator=g, requires_grad=True)
    labels = torch.randint(0, 19, (2, 65, 65), generator=g)
    labels[:, :3] = 255
    port = criterion_ohem_dsn({"main": main, "aux": aux}, labels, thresh=0.7,
                              min_kept=min_kept, impl="torch")
    ref = RT.criterion(main, aux, labels, 255, 0.7, min_kept)
    assert abs(float(port) - float(ref)) <= 1e-6 * abs(float(ref))
    gp = torch.autograd.grad(port, (main, aux))
    gr = torch.autograd.grad(ref, (main, aux))
    for a, b in zip(gp, gr):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_sgd_matches_port():
    from ccnet_tpu_torch.train.optim import make_optimizer

    g = torch.Generator().manual_seed(2)
    p = torch.nn.Parameter(torch.randn(50, generator=g))
    start = p.detach().clone()
    opt, sched = make_optimizer([p], 1e-2, 60000, 0.9, 0.9, 1e-4)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    for gr in grads:
        p.grad = gr.clone()
        opt.step()
        sched.step()
    q, buf = start.clone(), None
    for s, gr in enumerate(grads):
        d = gr + 1e-4 * q
        buf = d.clone() if buf is None else 0.9 * buf + d
        q = q - RT.poly_lr(1e-2, s, 60000, 0.9) * buf
    assert torch.allclose(p.detach(), q, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 9, 2 ** 31 + 11])
def test_augment_matches_port(seed):
    """The port's device augmenter and the reference's f64 matrices give the
    same crops (to f32 coordinate rounding) and the same labels, from the
    same seeded draws."""
    from ccnet_tpu_torch.data.preprocess import device_augment_batch

    images, labels = inputs.frames(seed, 3, (96, 128), 19, 255, 16, 2, 8.0, "cpu")
    mean = (104.00698793, 116.66876762, 122.67891434)
    for step in range(3):
        pi, pl = device_augment_batch(images, labels, seed=seed + 1, step=step,
                                      crop_hw=(65, 65), mean=mean)
        draws = RT.augment_draws(seed, step, 3, (96, 128), (65, 65), 0.7, 0.1, 15, True)
        ri, rl = RT.augment(images, labels, draws, (65, 65), mean, 255)
        assert (pi.permute(0, 3, 1, 2) - ri).abs().max() < 0.01
        assert torch.equal(pl.long(), rl)


def test_unknown_model_names_its_head_file():
    with pytest.raises(ValueError) as err:
        R.build(_config("nonet"), device="meta")
    assert os.path.join(REFERENCE, "heads", "nonet.py") in str(err.value)


def _sources():
    """Every Python file under ``reference/``, heads included."""
    for folder, _, files in os.walk(REFERENCE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(folder, name)


def test_reference_imports_nothing_of_the_program():
    paths = list(_sources())
    assert os.path.join(REFERENCE, "heads", "ccnet.py") in paths
    for name in paths:
        with open(name) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"ccnet_tpu_torch", "ccnet_tpu", "jax", "flax"}, name
