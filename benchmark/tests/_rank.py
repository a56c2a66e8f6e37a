"""One rank of a CPU test run of a multi-card cell, at the tiny size:

    python _rank.py ROOT RANK PORT FAULT ARG...

runs ``benchmark/run.py``'s ``main`` with ARG... on the CPU from ROOT as
rank RANK, the rendezvous on PORT, with FAULT (or ``none``) planted."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

import _tiny  # noqa: E402
from benchmark import run  # noqa: E402


class _Patch:
    def setitem(self, d, k, v):
        d[k] = v

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def plant(patch, fault: str) -> None:
    """``no_exchange``: every collective of the program returns the rank's
    own value and the gradients are not averaged over the ranks."""
    if fault == "none":
        return
    if fault != "no_exchange":
        raise ValueError(fault)
    import torch.distributed as dist

    from ccnet_tpu_torch.train import trainer

    patch.setattr(dist, "all_reduce", lambda t, *a, **k: None)
    patch.setattr(trainer, "data_parallel", lambda model: model)


if __name__ == "__main__":
    root, rank, port, fault, *argv = sys.argv[1:]
    patch = _Patch()
    _tiny.tiny_port(patch)
    plant(patch, fault)
    sys.exit(run.main(argv + ["--rank", rank, "--port", port], device="cpu", root=root))
