"""Port's Lovász losses, IoU metrics and ``criterion_ohem_dsn2`` vs the JAX package's.

The same numpy inputs go through :mod:`ccnet_tpu.losses.lovasz` (ignored
pixels folded in as sentinels that sort to the tail) and
:mod:`ccnet_tpu_torch.losses.lovasz` (ignored pixels gathered out), in f32:
values within 1e-5 relative, grads within 1e-5 x max|grad|. Probabilities
and logits are NHWC on the JAX side and NCHW on the port's.

Over two gloo ranks (``tests/_torch_space_worker.py``, spawned once for the
module, each with half of a global batch of 4 images): each criterion's
shares of the loss sum to JAX's loss of the global batch (1e-6 relative)
and to the port's one process (1e-6 relative), and each rank's gradient is
its half of JAX's (1e-5 x max|grad|): ``lovasz_softmax`` with ``per_image``
False and True (a class present only in rank 1's half), ``lovasz_hinge``
with ``per_image`` True and False, ``lovasz_hinge_flat`` and
``criterion_ohem_dsn2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccnet_tpu.losses import criterion as jcrit
from ccnet_tpu.losses import lovasz as J

from ccnet_tpu_torch.losses import build_criterion, criterion_ohem_dsn2
from ccnet_tpu_torch.losses import lovasz as L

from _torch_port import gloo_ranks, nchw, torch_threads


def _probas(seed, B=2, H=9, W=11, C=5, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, W, C).astype(np.float32) * 2
    probas = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(0, C - 1, (B, H, W)).astype(np.int32)  # class C-1 absent
    labels[rng.rand(B, H, W) < ignore_frac] = 255
    return probas.astype(np.float32), labels


def _rel(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def _grad_close(got, want):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("per_image", [False, True])
def test_lovasz_softmax_and_grad_match_jax(per_image):
    probas, labels = _probas(0)
    labels[1] = 255  # one image with no valid pixel (per_image: its term is 0)
    want, want_g = jax.value_and_grad(
        lambda p: J.lovasz_softmax(p, jnp.asarray(labels), 255, per_image))(jnp.asarray(probas))
    p = nchw(probas).requires_grad_(True)
    got = L.lovasz_softmax(p, torch.from_numpy(labels), 255, per_image)
    (got_g,) = torch.autograd.grad(got, p)
    _rel(got.detach(), want)
    _grad_close(got_g.permute(0, 2, 3, 1).numpy(), want_g)


def test_lovasz_softmax_no_valid_pixel_is_zero():
    probas, labels = _probas(1)
    labels[:] = 255
    assert float(L.lovasz_softmax(nchw(probas), torch.from_numpy(labels))) == 0.0
    assert float(J.lovasz_softmax(jnp.asarray(probas), jnp.asarray(labels))) == 0.0


def _binary(seed, B=3, H=7, W=8):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, H, W).astype(np.float32) * 2
    labels = rng.randint(0, 2, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.2] = 255
    return logits, labels


@pytest.mark.parametrize("per_image", [True, False])
@pytest.mark.parametrize("ignore", [None, 255])
def test_lovasz_hinge_and_grad_match_jax(per_image, ignore):
    logits, labels = _binary(2)
    if ignore is None:
        labels = (labels == 1).astype(np.int32)
    else:
        labels[0] = 255  # an image with no valid pixel
    want, want_g = jax.value_and_grad(
        lambda x: J.lovasz_hinge(x, jnp.asarray(labels), per_image, ignore))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = L.lovasz_hinge(x, torch.from_numpy(labels), per_image, ignore)
    (got_g,) = torch.autograd.grad(got, x)
    _rel(got.detach(), want)
    _grad_close(got_g.numpy(), want_g)


def test_flatten_and_lovasz_hinge_flat_match_jax():
    logits, labels = _binary(3)
    want = J.flatten_binary_scores(jnp.asarray(logits), jnp.asarray(labels), 255)
    got = L.flatten_binary_scores(torch.from_numpy(logits), torch.from_numpy(labels), 255)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _rel(L.lovasz_hinge_flat(*got), J.lovasz_hinge_flat(*want))
    _rel(L.lovasz_hinge_flat(got[0], (got[1] == 1).int()),
         J.lovasz_hinge_flat(want[0], (want[1] == 1).astype(jnp.int32)))
    assert float(L.lovasz_hinge_flat(got[0], got[1], torch.zeros_like(got[2]))) == 0.0


@pytest.mark.parametrize("ignore", [None, 255])
def test_binary_xloss_matches_jax(ignore):
    logits, labels = _binary(4)
    if ignore is None:
        labels = (labels == 1).astype(np.int32)
    _rel(L.binary_xloss(torch.from_numpy(logits), torch.from_numpy(labels), ignore),
         J.binary_xloss(jnp.asarray(logits), jnp.asarray(labels), ignore))


@pytest.mark.parametrize("per_image", [True, False])
def test_iou_metrics_equal_jax(per_image):
    rng = np.random.RandomState(5)
    preds = rng.randint(0, 4, (3, 6, 7))
    labels = rng.randint(0, 4, (3, 6, 7))
    labels[rng.rand(3, 6, 7) < 0.2] = 255
    assert L.iou(preds, labels, 4, ignore=255, per_image=per_image) == \
        J.iou(preds, labels, 4, ignore=255, per_image=per_image)
    bp, bl = (preds == 1).astype(int), np.where(labels == 255, 255, labels == 1)
    assert L.iou_binary(bp, bl, ignore=255, per_image=per_image) == \
        J.iou_binary(bp, bl, ignore=255, per_image=per_image)


def test_criterion_ohem_dsn2_and_grad_match_jax():
    """CE + Lovász-softmax on the materialised align-corners upsample of the
    main logits (7 -> 25, ratio 4); the aux head gets no gradient."""
    rng = np.random.RandomState(6)
    main, aux = (rng.randn(2, 7, 7, 6).astype(np.float32) for _ in range(2))
    labels = rng.randint(0, 6, (2, 25, 25)).astype(np.int32)
    labels[rng.rand(2, 25, 25) < 0.1] = 255
    want, want_g = jax.value_and_grad(lambda m: jcrit.criterion_ohem_dsn2(
        {"main": m, "aux": jnp.asarray(aux)}, jnp.asarray(labels)))(jnp.asarray(main))
    tout = {"main": nchw(main).requires_grad_(True), "aux": nchw(aux).requires_grad_(True)}
    for crit in (criterion_ohem_dsn2, build_criterion(use_lovasz=True)):
        got = crit(tout, torch.from_numpy(labels))
        got_g, aux_g = torch.autograd.grad(got, [tout["main"], tout["aux"]], allow_unused=True)
        _rel(got.detach(), want)
        _grad_close(got_g.permute(0, 2, 3, 1).numpy(), want_g)
        assert aux_g is None


RANKS = 2


def _global_cases():
    """name -> (worker function, port input, labels, kwargs, JAX loss of the
    global batch as a function of the NHWC / flat input)."""
    probas, labels = _probas(7, B=4, H=6, W=7, C=5)
    labels[:2][labels[:2] == 3] = 0  # class 3 only in rank 1's half; class 4 nowhere
    logits, blabels = _binary(8, B=4, H=6, W=7)
    rng = np.random.RandomState(9)
    main = rng.randn(4, 7, 7, 6).astype(np.float32)
    dlabels = rng.randint(0, 6, (4, 25, 25)).astype(np.int32)
    dlabels[rng.rand(4, 25, 25) < 0.1] = 255
    aux = jnp.zeros_like(main)
    jl = {k: jnp.asarray(v) for k, v in (("p", labels), ("b", blabels), ("d", dlabels))}
    return {
        "softmax": ("softmax", nchw(probas), labels, {"per_image": False}, probas,
                    lambda p: J.lovasz_softmax(p, jl["p"], 255, False)),
        "softmax_per_image": ("softmax", nchw(probas), labels, {"per_image": True}, probas,
                              lambda p: J.lovasz_softmax(p, jl["p"], 255, True)),
        "hinge_per_image": ("hinge", torch.from_numpy(logits), blabels,
                            {"per_image": True, "ignore": 255}, logits,
                            lambda x: J.lovasz_hinge(x, jl["b"], True, 255)),
        "hinge": ("hinge", torch.from_numpy(logits), blabels, {"per_image": False, "ignore": 255},
                  logits, lambda x: J.lovasz_hinge(x, jl["b"], False, 255)),
        "hinge_flat": ("hinge_flat", torch.from_numpy(logits.ravel()), blabels.ravel(), {},
                       logits.ravel(), lambda x: J.lovasz_hinge_flat(
                           x, jl["b"].ravel(), jl["b"].ravel() != 255)),
        "dsn2": ("dsn2", nchw(main), dlabels, {}, main,
                 lambda m: jcrit.criterion_ohem_dsn2({"main": m, "aux": aux}, jl["d"])),
    }


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    case_dir = tmp_path_factory.mktemp("lovasz_ranks")
    cases = _global_cases()
    torch.save({"layers": (1, 1, 1, 1), "lovasz": {
        name: (fn, x, torch.from_numpy(y), kw) for name, (fn, x, y, kw, _, _) in cases.items()}},
        case_dir / "case.pt")
    want = {}
    with gloo_ranks("_torch_space_worker.py", case_dir, RANKS), torch_threads(1):
        for name, (_, x, y, kw, jx, jfn) in cases.items():
            loss, grad = jax.value_and_grad(jfn)(jnp.asarray(jx))
            one = _one_process(name, x, torch.from_numpy(y), kw)
            want[name] = {"loss": float(loss), "grad": np.asarray(grad), "one": one}
    got = [torch.load(case_dir / f"rank{r}.pt", weights_only=False)["lovasz"]
           for r in range(RANKS)]
    return want, got


def _one_process(name, x, y, kw):
    if name == "dsn2":
        return float(criterion_ohem_dsn2({"main": x, "aux": x}, y))
    if name == "hinge_flat":
        return float(L.lovasz_hinge_flat(x, y, y != 255))
    fn = L.lovasz_softmax if name.startswith("softmax") else L.lovasz_hinge
    return float(fn(x, y, 255, **kw) if fn is L.lovasz_softmax else fn(x, y, **kw))


@pytest.mark.parametrize("name", ["softmax", "softmax_per_image", "hinge_per_image", "hinge",
                                  "hinge_flat", "dsn2"])
def test_lovasz_over_two_ranks_equals_jax_on_the_global_batch(two_ranks, name):
    want, got = two_ranks
    w = want[name]
    total = sum(r[name]["loss"] for r in got)
    np.testing.assert_allclose(total, w["loss"], rtol=1e-6)
    np.testing.assert_allclose(total, w["one"], rtol=1e-6)
    grads = [r[name]["grad"] for r in got]
    if name in ("softmax", "softmax_per_image", "dsn2"):  # NCHW shares of the NHWC batch
        grads = [g.permute(0, 2, 3, 1) for g in grads]
    _grad_close(torch.cat(grads).numpy(), w["grad"])
