"""A copy of the benchmark's files at sizes a CPU test can run.

``tiny_root(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into
``tmp`` and shrinks, in the copy only, the data: the trunk to one block a
layer, the frames to 96×128 with 16-pixel blocks, crops and tiles to 65².
``tiny_port(monkeypatch, root)`` gives the port the copy's trunk depth.
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAYERS = [1, 1, 1, 1]


def _edit(path: str, **changes) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)


def tiny_root(tmp) -> str:
    root = str(tmp)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = os.path.join(root, "benchmark")
    for name in os.listdir(os.path.join(here, "configs")):
        _edit(os.path.join(here, "configs", name), layers=LAYERS)
    frames = {"frame_hw": [96, 128], "pool": 4, "block": 16}
    for name in os.listdir(os.path.join(here, "traffic")):
        path = os.path.join(here, "traffic", name)
        with open(path) as f:
            kind = json.load(f)["driver"]
        if kind == "train":
            _edit(path, crop=[65, 65], batch=2, trace_skip=1, trace_steps=2, **frames)
        else:
            _edit(path, tile=[65, 65], check_requests=2, warmup_requests=1, trace_skip=1,
                  trace_steps=2, **frames)
    return root


def tiny_port(monkeypatch) -> None:
    from ccnet_tpu_torch.models import registry

    monkeypatch.setitem(registry._DEPTH_LAYERS, 101, tuple(LAYERS))
