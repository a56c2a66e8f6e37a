"""One gloo rank of ``tests/test_torch_data_parallel.py``.

Launched once per rank with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and a ``file://`` rendezvous, on the
CPU with one thread. It reads the case the test wrote (``case.pt``: weights,
global batches, ABN inputs, CLI arguments), runs each job through the port's
own entry points, and writes ``rank<r>.pt`` for the test to read:

* ``steps``: two train steps of the tiny CCNet on the rank's share of the
  global batches (``make_train_step`` on the ``DistributedDataParallel``
  replica), without dropout, with dropout 0.1, and with ``remat`` blocks and
  conv12: the logged losses and the final state dicts, and what the
  program's counters (``utils.trace.counts()``) gained over the steps;
* ``abn``: :class:`~ccnet_tpu_torch.nn.layers.ABN` in train mode on the
  rank's share of a global input (several values per channel, and one per
  rank): output, input grad, parameter grads and running stats;
* ``eval``: ``cli.evaluate.main`` (sliding) on the rank's share of a
  4-image set, into ``eval_r<rank>``;
* ``train_cli``: ``cli.train.main --synthetic`` into ``snap_r<rank>``;
* ``indivisible``: ``cli.train.main`` at a global batch of 3, which must exit.

Usage: python _torch_ddp_worker.py <case dir>
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

torch.set_num_threads(1)


def _steps(case, rank, size, drop_rate=0.0, remat=False):
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import CCNet
    from ccnet_tpu_torch.parallel import data_parallel, rank_slice
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import trace

    model = CCNet(num_classes=case["classes"], layers=case["layers"], recurrence=2,
                  drop_rate=drop_rate, remat=remat)
    model.load_state_dict(case["init"], strict=True)
    state = create_train_state(model, **case["optim"])
    step = make_train_step(build_criterion(ohem=True, **case["ohem"]), seed=case["seed"],
                           forward=data_parallel(model))
    before = trace.counts()
    losses = [float(step(state, rank_slice(x, rank, size), rank_slice(y, rank, size))["loss"])
              for x, y in zip(case["images"], case["labels"])]
    after = trace.counts()
    sd = model.state_dict()
    # the keys the test compares, and a digest of the whole state for the
    # ranks' agreement (the full state of every run would take ~0.5 GB)
    return {"losses": losses, "state": {k: sd[k].detach().clone() for k in case["keys"]},
            "digest": [float(v.double().abs().sum()) for v in sd.values()],
            "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


def _abn(case, rank, size):
    from ccnet_tpu_torch.nn.layers import ABN
    from ccnet_tpu_torch.parallel import rank_slice

    out = {}
    for name, (x, dy) in case["abn"].items():
        layer = ABN(x.shape[1]).train()
        xr = rank_slice(x, rank, size).clone().requires_grad_(True)
        y = layer(xr)
        y.backward(rank_slice(dy, rank, size))
        out[name] = {"y": y.detach(), "dx": xr.grad, "dweight": layer.weight.grad,
                     "dbias": layer.bias.grad, "running_mean": layer.running_mean.clone(),
                     "running_var": layer.running_var.clone()}
    return out


def main():
    case_dir = sys.argv[1]
    from ccnet_tpu_torch.parallel import maybe_initialize_distributed, world

    assert maybe_initialize_distributed(device="cpu",
                                        init_method=f"file://{case_dir}/rendezvous")
    assert maybe_initialize_distributed(device="cpu")  # a second call short-circuits
    rank, size = world()
    case = torch.load(os.path.join(case_dir, "case.pt"), weights_only=False)
    out = {"steps": _steps(case, rank, size),
           "steps_dropout": _steps(case, rank, size, drop_rate=0.1),
           "steps_remat": {mode: _steps(case, rank, size, remat=mode)
                           for mode in (True, "conv12")},
           "abn": _abn(case, rank, size)}

    from ccnet_tpu_torch.cli import evaluate, train
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.models import registry

    # the CLIs' --depth 50 builds the tiny trunk here, as in the test's process
    registry._DEPTH_LAYERS[50] = tuple(case["layers"])

    out["eval"] = evaluate.main(case["eval_argv"] + ["--output-dir",
                                                     os.path.join(case_dir, f"eval_r{rank}")],
                                dataset=SyntheticDataset(**case["eval_set"]))
    out["train_cli"] = train.main(case["train_argv"] + ["--snapshot-dir",
                                                        os.path.join(case_dir, f"snap_r{rank}")])
    try:
        train.main(case["train_argv"] + ["--batch-size", "3", "--snapshot-dir",
                                         os.path.join(case_dir, "snap_bad")])
        out["indivisible"] = None
    except SystemExit as e:
        out["indivisible"] = str(e)
    torch.save(out, os.path.join(case_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
