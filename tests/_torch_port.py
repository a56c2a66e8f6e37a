"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Each test makes its inputs with numpy from a seed, runs a ``ccnet_tpu``
function and its ``ccnet_tpu_torch`` counterpart on them, and compares the
numpy results. JAX stays on the CPU (``tests/conftest.py``); arrays cross
between the frameworks as numpy, NHWC on the JAX side and NCHW on the
port's model side.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

TINY_LAYERS = (1, 1, 1, 1)
TINY_CLASSES = 5


def to_numpy_tree(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)  # a writable copy: torch.from_numpy refuses read-only views


def randomized_variables(model, x, seed: int = 0):
    """Real init for convs, perturbed BN stats and 1-D params, and a non-zero
    CCA gamma, so the attention path and every BN move the logits (the
    recipe of ``tests/test_full_ccnet_torch_parity.py``)."""
    rng = np.random.RandomState(seed)
    variables = to_numpy_tree(jax.jit(lambda x: model.init(jax.random.PRNGKey(seed), x,
                                                            train=False))(x))

    def perturb_stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb_stats(v)
            elif k == "running_mean":
                out[k] = rng.randn(*v.shape).astype(np.float32) * 0.1
            else:  # running_var
                out[k] = rng.rand(*v.shape).astype(np.float32) + 0.5
        return out

    def perturb_params(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb_params(v)
            elif k == "gamma":
                out[k] = np.full(v.shape, 0.5, np.float32)
            elif v.ndim == 1:
                out[k] = rng.randn(*v.shape).astype(np.float32) * 0.1 + v
            else:
                out[k] = v
        return out

    return {"params": perturb_params(variables["params"]),
            "batch_stats": perturb_stats(variables["batch_stats"])}


def tiny_ccnet_pair(hw=(65, 65), seed: int = 0):
    """The tiny CCNet (layers (1,1,1,1), 5 classes, R=2, no dropout) in both
    packages with the same randomised f32 weights.

    Returns ``(jax_model, variables, torch_model)``; the torch model is in
    eval mode on the CPU with ``impl="auto"`` (the plain CCA there)."""
    from ccnet_tpu.models import CCNet as JaxCCNet
    from ccnet_tpu_torch.models import CCNet
    from ccnet_tpu_torch.utils.checkpoint import jax_variables_to_state_dict

    jm = JaxCCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2,
                  impl="jnp", drop_rate=0.0)
    variables = randomized_variables(jm, jnp.zeros((1, *hw, 3), jnp.float32), seed)
    tm = CCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2, drop_rate=0.0)
    tm.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return jm, variables, tm.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).cpu().numpy()


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` inside, restored after: the
    suite runs several workers on one machine's cores, and an oversubscribed
    OpenMP pool slows every worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def gloo_ranks(worker: str, case_dir, ranks: int = 2, timeout: float = 240.0):
    """Run ``tests/<worker> <case_dir>`` as ``ranks`` gloo ranks on the CPU
    (torchrun's variables, one thread each), while the body computes the
    references; on leaving, wait up to ``timeout`` seconds, kill a rank
    that is still running, and fail with a rank's log when it did not exit
    0. Yields the processes."""
    script = pathlib.Path(__file__).resolve().parent / worker
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "CCNET_TPU_NO_DISTRIBUTED")}
    procs = []
    try:
        for rank in range(ranks):
            env_r = dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(ranks),
                         LOCAL_WORLD_SIZE=str(ranks), OMP_NUM_THREADS="1")
            log = open(pathlib.Path(case_dir) / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(script), str(case_dir)],
                                           env=env_r, stdout=log, stderr=subprocess.STDOUT),
                          log))
        yield [p for p, _ in procs]
        for proc, _ in procs:
            proc.wait(timeout=timeout)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, (pathlib.Path(case_dir) / f"rank{rank}.log").read_text()[-4000:]
