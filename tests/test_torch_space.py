"""The port's ``space`` axis over two ranks, against one process and the JAX package.

Two gloo ranks (``tests/_torch_space_worker.py``, one process each, CPU,
one thread, a ``file://`` rendezvous under the test's temporary directory)
are spawned once for the module; the tests read what they wrote. While they
run, this process computes the references. The models are tiny (layers
(1, 1, 1, 1), 7 classes, f32) with the JAX package's randomised weights
(CCA ``gamma`` = 0.5, so the attention counts):

* (a) ``predict_multiscale(..., whole=True, space=...)``: each rank's rows
  equal the port's one-process rows (1e-5 × max|logit|) and JAX's
  single-device ``predict_multiscale(..., whole=True)`` (1e-4 ×
  max|logit|, argmax equal; JAX's slow ``tests/test_spatial_eval.py``
  holds that equal to its ``space=2`` mesh): CCNet at 64×96 (JAX's test
  shape) and at the odd height 65×96, PSPNet, DeepLabv3 (ASPP's dilation
  12 reads past a neighbour's 4 or 5 stride-8 rows, and past the image) and
  CCNet multi-scale + flip;
* (b) the communication pattern, from the group's counters: one exchange
  per padded convolution and pool, of the rows its window reads from the
  other shard and no more (bytes computed here from the one-process
  model's shapes); 3·R attention gathers and one gather of the logits,
  of their sizes exactly, so no other activation is gathered; PSPNet's
  four pools and DeepLabv3's image pool are one sum each;
* (c) ``cli.evaluate --whole 1 --space 2`` (3 images in batches of 2, so a
  ragged last batch) sums the one-process confusion; ``cli.predict --whole
  1 --space 2`` writes the one-process PNGs, from rank 0 only; ``--space 2``
  without ``--whole`` and ``--space 3`` over two ranks exit, as the JAX CLI
  does (in one process: ``tests/test_torch_predict.py``);
* (d) ``TrainConfig(space=2)`` over two ranks takes the ``space=1`` steps
  (``space`` folds into data parallelism); ``space=3`` raises ValueError.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.evaluation import predict_multiscale as jax_predict_multiscale
from ccnet_tpu.models import CCNet as JaxCCNet
from ccnet_tpu.models import DeepLabV3 as JaxDeepLabV3
from ccnet_tpu.models import PSPNet as JaxPSPNet

from ccnet_tpu_torch.cli import evaluate, predict
from ccnet_tpu_torch.data import SyntheticDataset
from ccnet_tpu_torch.data.palette import read_png
from ccnet_tpu_torch.evaluation import predict_multiscale
from ccnet_tpu_torch.models import build_model, registry
from ccnet_tpu_torch.models.ccnet import _ConcatConv
from ccnet_tpu_torch.nn.layers import Conv
from ccnet_tpu_torch.utils import jax_variables_to_state_dict, save_pth

from _torch_port import TINY_LAYERS, gloo_ranks, nchw, nhwc, randomized_variables, torch_threads

RANKS = 2
CLASSES = 7
PORT_REL = 1e-5  # against the port's one process: f32, sums split at the shards' rows
JAX_REL = 1e-4  # against JAX: f32 convolutions that sum in another order
JAX_MODELS = {"ccnet": lambda: JaxCCNet(num_classes=CLASSES, layers=TINY_LAYERS, recurrence=2,
                                        impl="jnp", drop_rate=0.0),
              "pspnet": lambda: JaxPSPNet(num_classes=CLASSES, layers=TINY_LAYERS),
              "deeplabv3": lambda: JaxDeepLabV3(num_classes=CLASSES, layers=TINY_LAYERS)}
# name: (model, image height, scales, flip); every image is 96 wide
CASES = {"ccnet_64": ("ccnet", 64, (1.0,), False),
         "ccnet_65": ("ccnet", 65, (1.0,), False),
         "pspnet_64": ("pspnet", 64, (1.0,), False),
         "deeplabv3_64": ("deeplabv3", 64, (1.0,), False),
         "ccnet_msflip": ("ccnet", 64, (0.75, 1.0), True)}
WIDTH = 96
BASE_ARGV = ["--device", "cpu", "--depth", "50", "--fp32", "1", "--num-classes", str(CLASSES),
             "--input-size", "33,33", "--whole", "1"]
EVAL_ARGV = BASE_ARGV + ["--num-workers", "1", "--batch-size", "2", "--save-preds", "1"]
EVAL_SET = dict(n=3, hw=(64, WIDTH), num_classes=CLASSES, seed=3)
PREDICT_SET = dict(n=2, hw=(65, WIDTH), num_classes=CLASSES, seed=4)
TRAIN = dict(model="ccnet", num_classes=CLASSES, depth=50, input_size=(33, 33), batch_size=4,
             num_steps=2, save_every=100, bf16=False, device="cpu", export_pth=False,
             ohem=True, ohem_keep=2000, log_every=1, augment_backend="device")


def _image(seed, height):
    return np.random.RandomState(seed).randn(1, height, WIDTH, 3).astype(np.float32) * 50


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("space")
    patch = pytest.MonkeyPatch()
    patch.setitem(registry._DEPTH_LAYERS, 50, TINY_LAYERS)
    variables, states = {}, {}
    for name, make in JAX_MODELS.items():
        jm = make()
        variables[name] = (jm, randomized_variables(jm, jnp.zeros((1, 64, WIDTH, 3)), seed=3))
        states[name] = jax_variables_to_state_dict(variables[name][1])
    images = {tag: _image(i, h) for i, (tag, (_, h, _, _)) in enumerate(CASES.items())}
    with torch_threads(1):
        model = build_model("ccnet", num_classes=CLASSES, depth=50)
        model.load_state_dict(states["ccnet"], strict=True)
        pth = str(case_dir / "ccnet.pth")
        save_pth(model, pth)
    case = {"classes": CLASSES, "layers": TINY_LAYERS, "dir": str(case_dir),
            "predict": {tag: {"model": m, "state": states[m], "image": nchw(images[tag]),
                              "scales": s, "flip": f} for tag, (m, _, s, f) in CASES.items()},
            "eval_argv": EVAL_ARGV + ["--restore-from", pth, "--space", str(RANKS)],
            "eval_set": EVAL_SET,
            "predict_argv": BASE_ARGV + ["--restore-from", pth, "--labelid", "0",
                                         "--space", str(RANKS)],
            "predict_set": PREDICT_SET,
            "exit_argv": {"no_whole": EVAL_ARGV + ["--whole", "0", "--space", str(RANKS)],
                          "indivisible": EVAL_ARGV + ["--space", str(RANKS + 1)]},
            "train": dict(TRAIN, snapshot_dir=str(case_dir / "snap")),
            "train_set": dict(n=8, hw=(48, 64), num_classes=CLASSES)}
    torch.save(case, case_dir / "case.pt")
    ref = {"port": {}, "jax": {}}
    try:
        with gloo_ranks("_torch_space_worker.py", case_dir, RANKS), torch_threads(1):
            for tag, (m, _, scales, flip) in CASES.items():
                jm, v = variables[m]
                kw = dict(scales=scales, flip=flip, whole=True)
                ref["jax"][tag] = np.asarray(jax.jit(lambda im: jax_predict_multiscale(
                    lambda t: jm.apply(v, t, train=False)["main"], im, (33, 33), CLASSES,
                    **kw))(images[tag]))
                model = build_model(m, num_classes=CLASSES, depth=50)
                model.load_state_dict(states[m], strict=True)
                model.eval()
                with torch.inference_mode():
                    ref["port"][tag] = predict_multiscale(
                        lambda x: model(x)["main"], nchw(images[tag]), (33, 33), CLASSES, **kw)
                if tag == "ccnet_64":
                    ref["shapes"] = _layer_shapes(model, nchw(images[tag]))
            ref["evaluate"] = evaluate.main(EVAL_ARGV + ["--restore-from", pth, "--output-dir",
                                                         str(case_dir / "eval_one")],
                                            dataset=SyntheticDataset(**EVAL_SET))
            ref["predict"] = predict.main(BASE_ARGV + ["--restore-from", pth, "--labelid", "0",
                                                       "--output-dir", str(case_dir / "pred_one")],
                                          dataset=SyntheticDataset(**PREDICT_SET))
        got = [torch.load(case_dir / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
        pngs = {d: {p.name: read_png(str(p), 3)[0] for p in sorted((case_dir / d).glob("*.png"))}
                for d in ("eval_one", "eval_r0", "eval_r1", "pred_one", "pred_r0", "pred_r1")}
        written = {d: (case_dir / d / "result.txt").is_file() for d in ("eval_r0", "eval_r1")}
    finally:
        patch.undo()
    return {"ref": ref, "ranks": got, "pngs": pngs, "result_txt": written}


def _layer_shapes(model, x):
    """The input shape of every padded convolution (``_ConcatConv``: its two
    inputs), of the max pool (conv3's output) and of the attention's q, k
    and v, in one process."""
    shapes, hooks = {}, []

    def keep(name, value):
        shapes.setdefault(name, value)  # the first call: R attention calls share the convs

    for name, m in model.named_modules():
        if isinstance(m, _ConcatConv) or (isinstance(m, Conv) and m.padding[0]):
            hooks.append(m.register_forward_hook(lambda mod, args, out, name=name: keep(
                name, (mod, [tuple(a.shape) for a in args], tuple(out.shape)))))
        if name in ("head.cca.query_conv", "head.cca.key_conv", "head.cca.value_conv"):
            hooks.append(m.register_forward_hook(
                lambda mod, args, out, name=name: keep(name, tuple(out.shape))))
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return shapes


@pytest.mark.parametrize("tag", list(CASES))
def test_ranks_rows_equal_one_process_and_jax(runs, tag):
    want = runs["ref"]["port"][tag]
    want_jax = runs["ref"]["jax"][tag]
    scale, scale_jax = float(want.abs().max()), float(np.abs(want_jax).max())
    spans = [r["predict"][tag]["span"] for r in runs["ranks"]]
    assert spans[0][0] == 0 and spans[0][1] == spans[1][0] and spans[1][1] == want.shape[2]
    for r, (a, b) in zip(runs["ranks"], spans):
        rows = r["predict"][tag]["rows"]
        assert rows.shape == (1, CLASSES, b - a, WIDTH)
        np.testing.assert_allclose(rows.numpy(), want[:, :, a:b].numpy(), atol=PORT_REL * scale)
        np.testing.assert_allclose(nhwc(rows), want_jax[:, a:b], atol=JAX_REL * scale_jax)
        np.testing.assert_array_equal(rows.argmax(dim=1).numpy(), want_jax[:, a:b].argmax(-1))


def _rows_read(p: int, stride: int, height: int, start: int) -> int:
    """Rows a window of padding ``p`` and stride ``stride`` reads across the
    shards' boundary at ``start`` of a map of ``height`` rows (two shards):
    a stride-2 window of 3 reads one row above its first output row's
    input, a stride-1 window ``p`` rows each way, the image's pad aside."""
    return 1 if stride == 2 else min(p, start) + min(p, height - start)


def test_communication_pattern_from_the_counters(runs):
    """CCNet 64×96: heights 64 → 32 → 17 → 9, shard 0 owns stride-8 rows
    [0, 5) and 8× those image rows, as the row rule states."""
    shapes = runs["ref"]["shapes"]
    h8 = shapes["head.cca.query_conv"][2]
    boundary = {h: -(-h8 // RANKS) * f for h, f in (
        (shapes["conv1"][1][0][2], 8), (shapes["conv2"][1][0][2], 4),
        (shapes["layer1.0.conv2"][1][0][2], 2), (h8, 1))}
    want_rows, want_bytes = [], 0
    for name, entry in shapes.items():
        if name.startswith("head.cca."):
            continue
        mod, ins, _ = entry
        stride, p = (1, 1) if isinstance(mod, _ConcatConv) else (mod.stride[0], mod.padding[0])
        height, width = ins[0][2], ins[0][3]
        rows = _rows_read(p, stride, height, boundary[height])
        want_rows.append(rows)
        want_bytes += rows * sum(s[1] for s in ins) * width * 4
    pool = shapes["conv3"][2]  # the max pool's input: conv3's output (3×3, stride 2, pad 1)
    want_rows.append(_rows_read(1, 2, pool[2], boundary[pool[2]]))
    want_bytes += want_rows[-1] * pool[1] * pool[3] * 4
    q, k, v = (shapes[f"head.cca.{n}_conv"] for n in ("query", "key", "value"))
    gather_bytes = 2 * 4 * (q[1] + k[1] + v[1]) * h8 * q[3] + CLASSES * h8 * q[3] * 4
    for r in runs["ranks"]:
        got = r["predict"]["ccnet_64"]
        rows = [n for kind, n, _ in got["events"] if kind == "exchange"]
        assert sorted(rows) == sorted(want_rows)  # one exchange per padded conv and pool
        assert got["counts"]["exchange"] == [len(want_rows), want_bytes]
        assert got["counts"]["gather"] == [3 * 2 + 1, gather_bytes]  # 3·R + the logits
        assert got["counts"]["sum"] == [0, 0]
        assert r["predict"]["pspnet_64"]["counts"]["sum"][0] == 4
        assert r["predict"]["deeplabv3_64"]["counts"]["sum"][0] == 1
        assert r["predict"]["ccnet_msflip"]["counts"]["gather"][0] == 4 * (3 * 2 + 1)


def test_evaluate_cli_space_sums_the_one_process_confusion(runs):
    want = runs["ref"]["evaluate"]
    for r in runs["ranks"]:
        got = r["cli"]["evaluate"]
        np.testing.assert_array_equal(np.asarray(got["confusion"]), np.asarray(want["confusion"]))
        assert got["meanIU"] == want["meanIU"]
        # 12 padded convolutions and pools a forward, one forward a batch (2, then 1)
        assert got["collectives"]["exchange"][0] == 12 * 2
    assert runs["result_txt"] == {"eval_r0": True, "eval_r1": False}
    one, r0, r1 = (runs["pngs"][d] for d in ("eval_one", "eval_r0", "eval_r1"))
    assert sorted(r0) == sorted(one) and len(one) == EVAL_SET["n"] and r1 == {}
    for name in one:
        np.testing.assert_array_equal(r0[name], one[name])


def test_predict_cli_space_writes_the_one_process_pngs_from_rank_0(runs):
    one, r0, r1 = (runs["pngs"][d] for d in ("pred_one", "pred_r0", "pred_r1"))
    assert len(one) == PREDICT_SET["n"] and sorted(r0) == sorted(one) and r1 == {}
    for name in one:
        assert one[name].shape == PREDICT_SET["hw"]
        np.testing.assert_array_equal(r0[name], one[name])
    assert runs["ranks"][1]["cli"]["predict"]["paths"] == []


@pytest.mark.parametrize("tag,needle", [("no_whole", "--whole"), ("indivisible", "divide")])
def test_space_flags_exit_over_two_ranks(runs, tag, needle):
    for r in runs["ranks"]:
        assert r["cli"]["exits"][tag] is not None and needle in r["cli"]["exits"][tag]


def test_train_space_folds_into_data_parallelism(runs):
    for r in runs["ranks"]:
        got = r["train"]
        assert got[RANKS]["losses"] == got[1]["losses"] and len(got[1]["losses"]) == 2
        assert got[RANKS]["digest"] == got[1]["digest"]
        assert got["indivisible"] is not None and "space=3" in got["indivisible"]
    assert runs["ranks"][0]["train"][1] == runs["ranks"][1]["train"][1]
