"""The port's process-group initialisation: the launch shapes of
``ccnet_tpu_torch.parallel.maybe_initialize_distributed``, the counterparts
of ``tests/test_distributed_init.py``'s, and the backend rule.

torchrun sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; without any of them the run is one
process. A group initialised here is destroyed before the test ends.
"""

import socket

import pytest
import torch
import torch.distributed as dist

import ccnet_tpu_torch.parallel.distributed as D
from ccnet_tpu_torch.parallel import (
    all_reduce_sum,
    choose_backend,
    is_primary_host,
    rank_device,
    rank_slice,
    world,
)

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "CCNET_TPU_NO_DISTRIBUTED")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun_env(monkeypatch, size=1, rank=0, port=True):
    monkeypatch.setenv("WORLD_SIZE", str(size))
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    if port:
        monkeypatch.setenv("MASTER_PORT", str(_free_port()))


def test_explicit_env_initializes_gloo_on_the_cpu(monkeypatch):
    _torchrun_env(monkeypatch)
    assert D.maybe_initialize_distributed(device="cpu") is True
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert world() == (0, 1) and is_primary_host()
    assert rank_device("cpu") == torch.device("cpu")


def test_explicit_env_rendezvous_failure_raises(monkeypatch):
    _torchrun_env(monkeypatch, port=False)  # env:// without MASTER_PORT cannot meet
    with pytest.raises((ValueError, RuntimeError)):
        D.maybe_initialize_distributed(device="cpu")
    assert not dist.is_initialized()


def test_incomplete_torchrun_env_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, RANK not set"):
        D.maybe_initialize_distributed(device="cpu")


def test_no_env_is_single_process(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("init_process_group called without torchrun's variables")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    assert D.maybe_initialize_distributed(device="cpu") is False
    assert world() == (0, 1) and is_primary_host()


def test_opt_out_env(monkeypatch):
    _torchrun_env(monkeypatch)
    monkeypatch.setenv("CCNET_TPU_NO_DISTRIBUTED", "1")
    assert D.maybe_initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


def test_second_call_short_circuits(monkeypatch):
    _torchrun_env(monkeypatch)
    assert D.maybe_initialize_distributed(device="cpu") is True

    def refuse(*a, **k):
        raise AssertionError("init_process_group called twice")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    assert D.maybe_initialize_distributed(device="cpu") is True


@pytest.mark.parametrize("local_ranks,cards,want", [
    (1, 1, "nccl"), (4, 4, "nccl"), (2, 8, "nccl"),  # a card of its own per rank
    (2, 1, "gloo"), (8, 4, "gloo"),  # ranks sharing a card
    (1, 0, "gloo"), (2, 0, "gloo")])  # the CPU
def test_backend_rule(local_ranks, cards, want):
    assert choose_backend(local_ranks, cards) == want


@pytest.mark.parametrize("env,cards,want", [
    ({"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"}, 1, "gloo"),  # two ranks, one card
    ({"WORLD_SIZE": "2"}, 1, "gloo"),  # local ranks default to the world size
    ({"WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4"}, 4, "nccl"),  # two hosts of four cards
    ({"WORLD_SIZE": "1"}, 1, "nccl")])  # one rank on one card
def test_backend_follows_the_launch(monkeypatch, env, cards, want):
    """The backend maybe_initialize_distributed asks for on CUDA, from
    torchrun's variables and the visible cards (init and cards mocked)."""
    asked = {}
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: asked.update(backend=backend, **kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: asked.update(card=index))
    _torchrun_env(monkeypatch, port=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert D.maybe_initialize_distributed(device="cuda") is True
    assert asked["backend"] == want
    assert asked["world_size"] == int(env["WORLD_SIZE"]) and asked["card"] == 0


def test_rank_slice_and_single_process_sum():
    t = torch.arange(12).reshape(6, 2)
    assert torch.equal(torch.cat([rank_slice(t, r, 3) for r in range(3)]), t)
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        rank_slice(t, 0, 4)
    assert all_reduce_sum(t) is t  # no group: the identity
