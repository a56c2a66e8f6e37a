"""One gloo rank of ``tests/test_torch_space.py`` and of the two-rank cases
of ``tests/test_torch_lovasz.py``.

Launched once per rank with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and a ``file://`` rendezvous, on the
CPU with one thread. It reads the case the test wrote (``case.pt``), runs
each job the case names through the port's own entry points, and writes
``rank<r>.pt`` for the test to read:

* ``predict``: ``predict_multiscale(..., whole=True, space=...)`` of each
  model and image over a space group of all ranks: the rank's rows, the
  rows it owns, and the group's collective counts and events of the case;
* ``cli``: ``cli.evaluate`` and ``cli.predict`` with ``--whole 1 --space N``
  (results, PNG paths), and the flags that must exit;
* ``train``: ``Trainer`` steps with ``space`` = 1 and = N over the ranks
  (losses, a digest of the state), and a ``space`` that does not divide
  the ranks;
* ``lovasz``: each Lovász criterion on the rank's share of the global
  inputs: its share of the loss and its gradient.

Usage: python _torch_space_worker.py <case dir>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

torch.set_num_threads(1)


def _predict(case, size):
    from ccnet_tpu_torch.evaluation import predict_multiscale
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.parallel import space_group

    group = space_group(size)
    out = {}
    for name, c in case["predict"].items():
        model = build_model(c["model"], num_classes=case["classes"], depth=50)
        model.load_state_dict(c["state"], strict=True)
        model.eval()
        group.counts = {k: [0, 0] for k in group.counts}
        with torch.inference_mode():
            rows = predict_multiscale(lambda x: model(x)["main"], c["image"], (33, 33),
                                      case["classes"], scales=c["scales"], flip=c["flip"],
                                      whole=True, space=group)
        out[name] = {"rows": rows, "span": group.rows(c["image"].shape[2]),
                     "counts": {k: list(v) for k, v in group.counts.items()},
                     "events": list(group.events)}
    return out


def _cli(case, rank):
    from ccnet_tpu_torch.cli import evaluate, predict
    from ccnet_tpu_torch.data import SyntheticDataset

    d = case["dir"]
    out = {"evaluate": evaluate.main(case["eval_argv"] + ["--output-dir", f"{d}/eval_r{rank}"],
                                     dataset=SyntheticDataset(**case["eval_set"])),
           "predict": predict.main(case["predict_argv"] + ["--output-dir", f"{d}/pred_r{rank}"],
                                   dataset=SyntheticDataset(**case["predict_set"])),
           "exits": {}}
    for tag, argv in case["exit_argv"].items():
        try:
            evaluate.main(argv + ["--output-dir", f"{d}/exit_r{rank}"],
                          dataset=SyntheticDataset(**case["eval_set"]))
            out["exits"][tag] = None
        except SystemExit as e:
            out["exits"][tag] = str(e)
    return out


def _train(case, size):
    from ccnet_tpu_torch.data import DataLoader, SyntheticDataset
    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    out = {}
    for space in (1, size):
        trainer = Trainer(TrainConfig(space=space, **case["train"]))
        loader = DataLoader(SyntheticDataset(**case["train_set"]), case["train"]["batch_size"]
                            // size, seed=1, num_workers=1)
        result = trainer.run(loader)
        out[space] = {"losses": result["losses"], "digest": [
            float(v.double().abs().sum()) for v in trainer.state.model.state_dict().values()]}
    try:
        Trainer(TrainConfig(space=size + 1, **case["train"]))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _lovasz(case, rank, size):
    from ccnet_tpu_torch.losses import criterion_ohem_dsn2
    from ccnet_tpu_torch.losses import lovasz as L
    from ccnet_tpu_torch.parallel import rank_slice

    fns = {
        "softmax": lambda x, y, kw: L.lovasz_softmax(x, y, 255, **kw),
        "hinge": lambda x, y, kw: L.lovasz_hinge(x, y, **kw),
        "hinge_flat": lambda x, y, kw: L.lovasz_hinge_flat(x, y, y != 255),
        "dsn2": lambda x, y, kw: criterion_ohem_dsn2({"main": x, "aux": x.detach()}, y),
    }
    out = {}
    for name, (fn, x, y, kw) in case["lovasz"].items():
        mine = rank_slice(x, rank, size).clone().requires_grad_(True)
        loss = fns[fn](mine, rank_slice(y, rank, size), kw)
        (grad,) = torch.autograd.grad(loss, mine)
        out[name] = {"loss": float(loss), "grad": grad}
    return out


def main():
    case_dir = sys.argv[1]
    from ccnet_tpu_torch.models import registry
    from ccnet_tpu_torch.parallel import maybe_initialize_distributed, world

    assert maybe_initialize_distributed(device="cpu",
                                        init_method=f"file://{case_dir}/rendezvous")
    rank, size = world()
    case = torch.load(os.path.join(case_dir, "case.pt"), weights_only=False)
    # --depth 50 builds the tiny trunk here, as in the test's process
    registry._DEPTH_LAYERS[50] = tuple(case["layers"])
    out = {}
    if "predict" in case:
        out["predict"] = _predict(case, size)
    if "eval_argv" in case:
        out["cli"] = _cli(case, rank)
    if "train" in case:
        out["train"] = _train(case, size)
    if "lovasz" in case:
        out["lovasz"] = _lovasz(case, rank, size)
    torch.save(out, os.path.join(case_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
