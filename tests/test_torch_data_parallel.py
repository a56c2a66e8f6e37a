"""The port's data parallelism: an N-rank step equals the one-process step.

Two gloo ranks (``tests/_torch_ddp_worker.py``, one process each, CPU, one
thread, a ``file://`` rendezvous under the test's temporary directory) are
spawned once for the module; the tests read what they wrote. While they
run, this process computes the references:

* (a) two train steps of the tiny CCNet (5 classes, layers (1,1,1,1), 33²
  crops, f32, no dropout, OHEM with a binding k-th statistic) at global
  batch 4 equal the JAX package's 2-device mesh step from the same weights
  on the same global batches, in loss, parameters and BN running stats;
* (b) the same run, with and without dropout, and with ``remat``, equals the
  port's one-process step at batch 4; and ``cli.train --synthetic`` over two
  ranks equals it in one process on the same global batches;
* (c) a sensitivity guard: on these inputs the per-rank OHEM threshold, the
  per-rank masked mean and per-rank BN moments each move the loss by more
  than (a)'s tolerance, so plain DDP would fail (a);
* (d) ``ABN``'s global moments against one-process BN on the concatenated
  batch, also at one value per channel and rank and at a mean 30 times
  the spread;
* (e) 2-rank sliding ``cli.evaluate`` over 4 images: the summed confusion
  equals the one-process one exactly; only rank 0 writes ``result.txt``;
* (f) only rank 0 writes the checkpoint and the ``.pth``;
* (g) a global batch that does not divide over the ranks exits.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.losses import build_criterion as jax_criterion
from ccnet_tpu.models import CCNet as JaxCCNet
from ccnet_tpu.parallel import make_mesh, shard_batch
from ccnet_tpu.train import create_train_state as jax_state
from ccnet_tpu.train import make_optimizer as jax_optimizer
from ccnet_tpu.train import make_train_step as jax_step

from ccnet_tpu_torch.cli import evaluate, train
from ccnet_tpu_torch.data import SyntheticDataset
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import CCNet, build_model, randomize_, registry
from ccnet_tpu_torch.nn.layers import ABN
from ccnet_tpu_torch.parallel import RankOrder
from ccnet_tpu_torch.train import create_train_state, make_train_step
from ccnet_tpu_torch.utils import jax_variables_to_state_dict, save_pth

from _torch_port import TINY_CLASSES, TINY_LAYERS, nchw, randomized_variables, to_numpy_tree, \
    torch_threads

RANKS = 2
HW = (33, 33)
BATCH = 4  # global
STEPS = 2
SEED = 11
OPTIM = dict(base_lr=1e-2, max_steps=50, weight_decay=5e-4)
# p_correct of the first step's main head lies mostly in 0.15-0.3 at these
# weights: below thresh 0.2 too few pixels to reach k, so p_k (the 1500th of
# ~2900 valid pixels) binds; rank 0 alone would take another p_k, rank 1
# alone holds fewer than min_kept valid pixels and would keep them all
OHEM = dict(thresh=0.2, min_kept=1500)
# (a): test_torch_train.py's tolerances for the port against JAX in f32: the
# loss to 2e-4, BN stats and head parameters to 1e-2 of what the steps
# changed, the ill-conditioned backbone convs to 0.25 of it. The attention's
# query conv changes by ~4e-5 in these two steps, and the port's own
# one-process step lands 3.2e-2 of that from JAX's (a CPU check made when
# this test was written): held at 5e-2.
LOSS_RTOL = 2e-4
CCA_SHARE = 5e-2
# (b): the same f32 arithmetic as one process but for the order of the sums
# the global reductions split over two ranks: the losses agreed to 2e-7 and
# the states to 1.9e-3 of what the steps changed (layer4.0.conv2; a CPU check
# made when this test was written)
PORT_LOSS_RTOL = 1e-5
PORT_SHARE = 1e-2
WORKER_TIMEOUT = 240  # seconds; the ranks take ~30 s here

HEAD_KEYS = ["head.bottleneck.3.weight", "head.bottleneck.1.weight",
             "head.cca.query_conv.weight", "dsn.3.weight", "dsn.1.weight"]
BACKBONE_KEYS = ["conv1.weight", "layer4.0.conv2.weight"]
STAT_KEYS = ["bn1.running_mean", "bn1.running_var", "layer3.0.bn2.running_var",
             "head.conva.1.running_mean", "head.bottleneck.1.running_var", "dsn.1.running_var"]

EVAL_SET = dict(n=4, hw=(40, 56), num_classes=TINY_CLASSES, seed=3)
EVAL_ARGV = ["--device", "cpu", "--depth", "50", "--fp32", "1", "--num-classes",
             str(TINY_CLASSES), "--input-size", "33,33", "--num-workers", "1",
             "--save-preds", "1"]
# cli.train with dropout 0.1, OHEM and the device augmenter's crops and
# mirrors drawn for the global batch. Its crops of smooth synthetic images
# make BN ill-conditioned: in ONE process, F.batch_norm (what one rank
# runs) against the N-rank layer's arithmetic (the same moments up to f32
# rounding) moves the parameters after two steps by 6.1e-2 of their
# change, as far as two ranks move them (a CPU check made when this test
# was written). So the exported weights are held at 0.25 of the change,
# the backbone tolerance of test_torch_train.py, with random scales off;
# test_device_augment_draws_are_the_global_batchs covers the scale draws,
# and the steps above hold the ranks to 1e-2 where BN is well-conditioned.
CLI_SHARE = 0.25
TRAIN_ARGV = ["--device", "cpu", "--depth", "50", "--fp32", "1", "--num-classes",
              str(TINY_CLASSES), "--input-size", "33,33", "--synthetic-size", "48,64",
              "--batch-size", str(BATCH), "--num-steps", "2", "--save-pred-every", "2",
              "--ohem", "1", "--ohem-keep", "3000", "--num-workers", "1",
              "--random-scale", "0"]


def _batches():
    """Two global batches. Rank 1's share has twelve times the ignored
    pixels and only classes 0 and 1, so the ranks' valid counts and mean
    losses differ."""
    rng = np.random.RandomState(1234)
    images = rng.randn(STEPS, BATCH, *HW, 3).astype(np.float32) * 30.0
    labels = rng.randint(0, TINY_CLASSES, size=(STEPS, BATCH, *HW)).astype(np.int32)
    labels[:, BATCH // RANKS:] %= 2
    ignore = rng.rand(STEPS, BATCH, *HW) < np.array([0.05, 0.05, 0.6, 0.6])[None, :, None, None]
    labels[ignore] = 255
    return images, labels


def _abn_cases():
    rng = np.random.RandomState(5)
    x = rng.randn(BATCH, 6, 5, 7).astype(np.float32) * 2.0 + 0.5
    x[BATCH // 2:] += 1.5  # the ranks' moments differ
    one = rng.randn(RANKS, 6, 1, 1).astype(np.float32)  # one value per channel per rank
    cases = {name: (torch.from_numpy(a), torch.from_numpy(rng.randn(*a.shape).astype(np.float32)))
             for name, a in (("map", x), ("one_value", one))}
    # a mean 30 times the spread: E[x²] − mean² in f32 would miss y and the
    # weight grad by up to 1.3e-4 and 8.4e-4 past the tolerances below, while
    # two-pass moments stay inside them (a CPU check made when this test was
    # written)
    far = (rng.randn(BATCH, 6, 5, 7) * 0.1 + 3.0).astype(np.float32)
    far[BATCH // 2:] += 0.15
    cases["far_mean"] = (torch.from_numpy(far),
                         torch.from_numpy(rng.randn(*far.shape).astype(np.float32)))
    return cases


def _port_steps(init, images, labels, drop_rate=0.0, remat=False):
    model = CCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2,
                  drop_rate=drop_rate, remat=remat)
    model.load_state_dict(init, strict=True)
    state = create_train_state(model, **OPTIM)
    step = make_train_step(build_criterion(ohem=True, **OHEM), seed=SEED)
    losses = [float(step(state, nchw(x), torch.from_numpy(y))["loss"])
              for x, y in zip(images, labels)]
    return {"losses": losses, "state": {k: v.detach() for k, v in model.state_dict().items()}}


def _jax_mesh_steps(jm, variables, images, labels):
    tx = jax_optimizer(**OPTIM)
    state = jax_state(jm, tx, input_shape=(1, *HW, 3), rng=jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    mesh = make_mesh(jax.devices()[:RANKS])
    step = jax_step(jm, jax_criterion(ohem=True, **OHEM), tx, mesh=mesh)
    losses = []
    for x, y in zip(images, labels):
        state, metrics = step(state, *shard_batch(mesh, x, y), jax.random.PRNGKey(7))
        losses.append(float(metrics["loss"]))
    final = to_numpy_tree({"params": state.params, "batch_stats": state.batch_stats})
    return {"losses": losses, "state": jax_variables_to_state_dict(final)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("ddp")
    jm = JaxCCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2, impl="jnp",
                  drop_rate=0.0)
    variables = randomized_variables(jm, jnp.zeros((1, *HW, 3), jnp.float32), seed=2)
    init = jax_variables_to_state_dict(variables)
    images, labels = _batches()
    # the CLIs' --depth 50 builds the tiny trunk here and in the ranks: R50
    # at 33² crops and 2 images a rank is so ill-conditioned that switching
    # F.batch_norm for the JAX formula of the same moments (E[x²] − mean²)
    # in ONE process moves its first-step grads by up to 39 % (a CPU check
    # made when this test was written)
    patch = pytest.MonkeyPatch()
    patch.setitem(registry._DEPTH_LAYERS, 50, TINY_LAYERS)
    with torch_threads(1):  # the eval model's weights: randomised, as the ranks load them
        eval_model = build_model("ccnet", num_classes=TINY_CLASSES, depth=50, seed=4)
        randomize_(eval_model, seed=4)
    pth = str(case_dir / "eval.pth")
    save_pth(eval_model, pth)
    case = {"classes": TINY_CLASSES, "layers": TINY_LAYERS, "init": init, "seed": SEED,
            "optim": OPTIM, "ohem": OHEM, "keys": HEAD_KEYS + BACKBONE_KEYS + STAT_KEYS,
            "images": [nchw(x) for x in images], "labels": [torch.from_numpy(y) for y in labels],
            "abn": _abn_cases(), "eval_set": EVAL_SET,
            "eval_argv": EVAL_ARGV + ["--restore-from", pth],
            "train_argv": TRAIN_ARGV + ["--synthetic"]}
    torch.save(case, case_dir / "case.pt")
    worker = pathlib.Path(__file__).resolve().parent / "_torch_ddp_worker.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "CCNET_TPU_NO_DISTRIBUTED")}
    procs = []
    for rank in range(RANKS):
        env_r = dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(RANKS),
                     LOCAL_WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1")
        log = open(case_dir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(worker), str(case_dir)],
                                       env=env_r, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        with torch_threads(1):
            ref = {"jax": _jax_mesh_steps(jm, variables, images, labels),
                   "steps": _port_steps(init, images, labels),
                   "steps_dropout": _port_steps(init, images, labels, drop_rate=0.1),
                   "images": images, "labels": labels, "init": init}
            ref["eval"] = evaluate.main(EVAL_ARGV + ["--restore-from", pth, "--output-dir",
                                                     str(case_dir / "eval_one")],
                                        dataset=SyntheticDataset(**EVAL_SET))
            # the global batches of cli.train --synthetic over two ranks, in one process
            synthetic = SyntheticDataset(n=max(BATCH * 4, 16), hw=(48, 64),
                                         num_classes=TINY_CLASSES)
            ref["train_cli"] = train.main(
                [a for a in TRAIN_ARGV] + ["--augment-backend", "device", "--cache-decoded",
                                           "0", "--snapshot-dir", str(case_dir / "snap_one")],
                dataset=RankOrder(synthetic, BATCH, RANKS, seed=304))
        for proc, log in procs:
            proc.wait(timeout=WORKER_TIMEOUT)
    finally:
        patch.undo()
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (case_dir / f"rank{rank}.log").read_text()[-4000:]
    got = [torch.load(case_dir / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    pths = [torch.load(case_dir / d / "CS_scenes_2.pth") for d in ("snap_r0", "snap_one")]
    with pytest.MonkeyPatch.context() as mp:  # cli.train's init: the seed, the tiny trunk
        mp.setitem(registry._DEPTH_LAYERS, 50, TINY_LAYERS)
        pths.append(build_model("ccnet", num_classes=TINY_CLASSES, depth=50,
                                seed=304).state_dict())
    files = {d: sorted(p.name for p in (case_dir / d).glob("*")) if (case_dir / d).is_dir()
             else [] for d in ("snap_r0", "snap_r1", "eval_r0", "eval_r1")}
    # the checkpoints, weights and the case take ~1.5 GB: gone before the tests run
    shutil.rmtree(case_dir)
    return {"ref": ref, "ranks": got, "pths": pths, "files": files}


def _off_by(got, want, init, key) -> float:
    """max |got − want| over the largest change the steps made to ``key``
    (0 where neither moved)."""
    off = (got[key].double() - want[key]).abs().max()
    return float(off / (want[key].double() - init[key]).abs().max()) if off else 0.0


def test_ranks_agree_with_each_other(runs):
    a, b = (r["steps"] for r in runs["ranks"])
    assert a["losses"] == b["losses"]
    assert a["digest"] == b["digest"]


def test_two_rank_steps_match_jax_mesh_loss(runs):
    np.testing.assert_allclose(runs["ranks"][0]["steps"]["losses"],
                               runs["ref"]["jax"]["losses"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("key,share", [(k, CCA_SHARE if ".cca." in k else 1e-2)
                                       for k in HEAD_KEYS + STAT_KEYS]
                         + [(k, 0.25) for k in BACKBONE_KEYS])
def test_two_rank_steps_match_jax_mesh_state(runs, key, share):
    got = runs["ranks"][0]["steps"]["state"]
    assert _off_by(got, runs["ref"]["jax"]["state"], runs["ref"]["init"], key) <= share


@pytest.mark.parametrize("run", ["steps", "steps_dropout"])
def test_two_rank_steps_match_one_process(runs, run):
    got, want = runs["ranks"][0][run], runs["ref"][run]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PORT_LOSS_RTOL)
    for key in HEAD_KEYS + BACKBONE_KEYS + STAT_KEYS:
        assert _off_by(got["state"], want["state"], runs["ref"]["init"], key) <= PORT_SHARE, key


def test_dropout_moves_the_two_rank_steps(runs):
    """The dropout leg of the test above is not the no-dropout run again."""
    a, b = runs["ranks"][0]["steps"]["losses"], runs["ranks"][0]["steps_dropout"]["losses"]
    assert abs(a[1] - b[1]) > 100 * PORT_LOSS_RTOL * abs(a[1])


@pytest.mark.parametrize("mode", [True, "conv12"])
def test_two_rank_remat_matches_two_rank_steps(runs, mode):
    """remat's recompute issues the same collectives on both ranks (no
    deadlock) and leaves the running stats updated once per step."""
    got, want = runs["ranks"][0]["steps_remat"][mode], runs["ranks"][0]["steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PORT_LOSS_RTOL)
    for key in HEAD_KEYS + BACKBONE_KEYS + STAT_KEYS:
        assert _off_by(got["state"], want["state"], runs["ref"]["init"], key) <= PORT_SHARE, key


def _first_loss(init, images, labels, per_rank=(), ranks=RANKS) -> float:
    """The first step's loss on the global batch, with the reductions in
    ``per_rank`` taken over each rank's share alone and the shares' losses
    averaged, as plain DDP would: ``"ohem"`` (the threshold), ``"mean"``
    (the masked means' counts) and ``"bn"`` (BN moments)."""
    from ccnet_tpu_torch.losses import criterion as C
    from ccnet_tpu_torch.losses.cross_entropy import masked_mean
    from ccnet_tpu_torch.losses.ohem import ohem_keep_mask

    model = CCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2, drop_rate=0.0)
    model.load_state_dict(init, strict=True)
    model.train()
    x, y = nchw(images[0]), torch.from_numpy(labels[0])
    with torch.no_grad():
        if "bn" in per_rank:
            parts = [model(xs) for xs in x.chunk(ranks)]
            out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        else:
            out = model(x)
        nll = C._nll(out["main"], y)
        valid = y != 255
        p = torch.exp(-nll)
        if "ohem" in per_rank:
            keep = torch.cat([ohem_keep_mask(ps, vs, **OHEM)
                              for ps, vs in zip(p.chunk(ranks), valid.chunk(ranks))])
        else:
            keep = ohem_keep_mask(p, valid, **OHEM)
        aux = C._nll(out["aux"], y)
        if "mean" in per_rank:
            return float(sum(masked_mean(n, k) + 0.4 * masked_mean(a, v) for n, k, a, v in zip(
                nll.chunk(ranks), keep.chunk(ranks), aux.chunk(ranks), valid.chunk(ranks)))
                / ranks)
        return float(masked_mean(nll, keep) + 0.4 * masked_mean(aux, valid))


@pytest.mark.parametrize("per_rank", ["ohem", "mean", "bn"])
def test_per_rank_reductions_would_break_the_tolerance(runs, per_rank):
    """(c): each reduction taken per rank alone moves the first step's loss
    by more than LOSS_RTOL, so (a) would fail under plain DDP."""
    ref = runs["ref"]
    with torch_threads(1):
        global_loss = _first_loss(ref["init"], ref["images"], ref["labels"])
        local_loss = _first_loss(ref["init"], ref["images"], ref["labels"], (per_rank,))
    np.testing.assert_allclose(global_loss, ref["jax"]["losses"][0], rtol=LOSS_RTOL)
    assert abs(local_loss - global_loss) > 5 * LOSS_RTOL * abs(global_loss), \
        (per_rank, local_loss, global_loss)


@pytest.mark.parametrize("name", ["map", "one_value", "far_mean"])
def test_abn_global_moments_match_one_process_bn(runs, name):
    """(d): output, input grad, parameter grads (summed over the ranks, as
    the data-parallel wrapper combines them) and running stats, also where
    the mean dwarfs the spread."""
    x, dy = _abn_cases()[name]
    layer = ABN(x.shape[1]).train()
    xg = x.clone().requires_grad_(True)
    y = layer(xg)
    y.backward(dy)
    got = [r["abn"][name] for r in runs["ranks"]]
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), xg.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(sum(g["dweight"] for g in got), layer.weight.grad,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(g["dbias"] for g in got), layer.bias.grad,
                               rtol=1e-5, atol=1e-5)
    for g in got:
        torch.testing.assert_close(g["running_mean"], layer.running_mean, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g["running_var"], layer.running_var, rtol=1e-5, atol=1e-6)


def test_two_rank_evaluation_sums_to_the_one_process_confusion(runs):
    """(e): equal integer for integer; each rank wrote the PNGs of its own
    two images and only rank 0 wrote result.txt."""
    want = np.asarray(runs["ref"]["eval"]["confusion"])
    assert want.sum() > 0
    for r in runs["ranks"]:
        np.testing.assert_array_equal(np.asarray(r["eval"]["confusion"]), want)
    files = runs["files"]
    assert "result.txt" in files["eval_r0"] and "result.txt" not in files["eval_r1"]
    pngs = [[f for f in files[f"eval_r{r}"] if f.endswith(".png")] for r in range(RANKS)]
    assert all(len(p) == 2 for p in pngs) and not set(pngs[0]) & set(pngs[1])


def test_two_rank_cli_train_matches_one_process(runs):
    """(b): ``cli.train --synthetic`` over two ranks (device augmentation
    drawn for the global batch, dropout 0.1, OHEM) against one process on
    the same global batches: losses and the exported .pth."""
    got, want = runs["ranks"][0]["train_cli"], runs["ref"]["train_cli"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=PORT_LOSS_RTOL)
    a, b, init = runs["pths"]
    assert a.keys() == b.keys()
    shares = sorted(((_off_by(a, b, init, k), k) for k in a), reverse=True)
    assert shares[0][0] <= CLI_SHARE, shares[:8]


def test_only_rank_zero_writes_checkpoints(runs):
    """(f)"""
    files = runs["files"]
    assert "CS_scenes_2.pth" in files["snap_r0"]
    assert any(f.startswith("step_") for f in files["snap_r0"])
    assert files["snap_r1"] == []


def test_indivisible_global_batch_exits(runs):
    """(g)"""
    for r in runs["ranks"]:
        assert r["indivisible"] is not None and "must divide over 2" in r["indivisible"]


def test_device_augment_draws_are_the_global_batchs():
    """Each rank's crops (scales, offsets, mirrors) are the one-process crops
    of its share of the global batch."""
    from ccnet_tpu_torch.data.preprocess import device_augment_batch

    rng = np.random.RandomState(9)
    images = torch.from_numpy(rng.randint(0, 256, (BATCH, 40, 56, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, TINY_CLASSES, (BATCH, 40, 56)).astype(np.uint8))
    kw = dict(seed=3, step=5, crop_hw=(33, 33))
    want = device_augment_batch(images, labels, **kw)
    share = BATCH // RANKS
    got = [device_augment_batch(images[r * share:(r + 1) * share],
                                labels[r * share:(r + 1) * share], rank=r, ranks=RANKS, **kw)
           for r in range(RANKS)]
    for i in range(2):
        torch.testing.assert_close(torch.cat([g[i] for g in got]), want[i], rtol=0, atol=0)
