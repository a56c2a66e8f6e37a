"""End-to-end learnability run of the PyTorch/CUDA port at the flagship
config (CCNet-R101, R=2), the port of ``scripts/e2e_synthetic.py``.

Trains with the port's real pipeline (``Trainer``: device augmentation,
OHEM+DSN, bf16, the hand-written kernels on a card, checkpointing) on
synthetic colour-coded data, exports the ``.pth``, scores held-out images
with the port's sliding-window ``Evaluator``, then CROSS-ECOSYSTEM: an
independent torch replica of the reference network
(``tests/_torch_reference_replica.py``, plain-torch attention, the
reference's module names) loads the same ``.pth`` in f32 and scores the
same held-out images whole. It prints both meanIUs, the share of valid
pixels on which the two predictions agree, and the trained attention
``gamma`` as each network reads it (far from 0, the attention kernels
matter to the score).

Passes when held-out meanIU > 0.5 through both (the JAX script's bar). If
not, the recipe runs again on the plain route (``impl="torch"``: no
hand-written kernel) and the run fails with both numbers: a diagnosis,
never a pass.

    python scripts/e2e_synthetic_torch.py [--device cuda]

Runs on the CUDA card (it raises when there is none) unless given
``--device cpu``. ``E2E_DEPTH=50`` for the R50 variant, ``E2E_STEPS`` (300)
for the step count, ``E2E_SKIP_TORCH=1`` to skip the replica's leg, as in
the JAX script. The tests call :func:`run` at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from _torch_reference_replica import TorchCCNet  # noqa: E402
from ccnet_tpu_torch.data import DataLoader  # noqa: E402
from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR  # noqa: E402
from ccnet_tpu_torch.evaluation import Evaluator, iou_from_confusion  # noqa: E402
from ccnet_tpu_torch.models import build_model  # noqa: E402
from ccnet_tpu_torch.ops import launch_counts  # noqa: E402
from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from ccnet_tpu_torch.utils import load_pth, resolve_device  # noqa: E402

# the JAX script's recipe (scripts/e2e_synthetic.py:50-53): 300 steps, batch
# 8 of 353² crops from 512x1024 images, 2 held-out images
STEPS, BATCH, CROP, HW, HELD_OUT = 300, 8, 353, (512, 1024), 2
LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
NUM_CLASSES = 19
MIN_MIOU = 0.5


class LearnableDS:
    """Images encode their labels (one-hot color + noise), blocky 64px."""
    def __init__(self, n=8, hw=(512, 1024), seed=0):
        self.n, self.hw, self.seed = n, hw, seed
    def __len__(self): return self.n
    def name(self, i): return f"syn_{i}"
    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed + i)
        h, w = self.hw
        blocks = rng.randint(0, 19, (h // 64 + 1, w // 64 + 1))
        lbl = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w].astype(np.int32)
        colors = np.random.RandomState(42).uniform(20.0, 235.0, (19, 3))
        img = (colors[lbl] + rng.randn(h, w, 3) * 8.0).astype(np.float32)
        return img, lbl, self.name(i)


def log(msg: str) -> None:
    print(msg, flush=True)


def _confusion(lbl: np.ndarray, pred: np.ndarray) -> np.ndarray:
    valid = lbl != 255
    return np.bincount(NUM_CLASSES * lbl[valid].astype(np.int64) + pred[valid],
                       minlength=NUM_CLASSES ** 2).reshape(NUM_CLASSES, NUM_CLASSES)


def replica_predict(pth: str, depth: int, images, device: torch.device) -> tuple:
    """The reference replica (f32, TF32 off) loads ``pth`` as the JAX
    script's leg does (no unexpected key; missing only
    ``num_batches_tracked``) and predicts each raw BGR image whole: logits
    upsampled align-corners to the image, argmax. Returns (trainIds, its
    ``gamma``)."""
    tm = TorchCCNet(NUM_CLASSES, LAYERS[depth], 2)
    load = tm.load_state_dict(torch.load(pth, map_location="cpu", weights_only=False),
                              strict=False)
    if load.unexpected_keys or not all(k.endswith("num_batches_tracked")
                                       for k in load.missing_keys):
        raise AssertionError(f"the replica reads {pth} with unexpected keys "
                             f"{load.unexpected_keys[:5]}, missing {load.missing_keys[:5]}")
    tm.eval().to(device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    preds = []
    try:
        with torch.no_grad():
            for img in images:
                x = img - np.asarray(CITYSCAPES_MEAN_BGR, np.float32)
                xt = torch.from_numpy(x.transpose(2, 0, 1)[None].copy()).to(device)
                main, _ = tm(xt)
                up = torch.nn.functional.interpolate(main, size=img.shape[:2], mode="bilinear",
                                                     align_corners=True)
                preds.append(up.argmax(1)[0].cpu().numpy())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return preds, float(tm.head.cca.gamma.item())


def run(depth: int = 101, steps: int = STEPS, batch: int = BATCH, crop: int = CROP,
        hw=HW, device: str = "cuda", snap_dir: str = "snapshots_e2e", impl: str = "auto",
        replica: bool = True) -> dict:
    """Train CCNet R``depth`` R=2 bf16 with OHEM (``ohem_keep`` 30000) at
    batch ``batch`` of ``crop``² crops of ``hw`` ``LearnableDS`` images for
    ``steps`` steps (lr 5e-3), export ``CS_scenes_{steps}.pth`` to
    ``snap_dir``, load it strictly into a fresh bf16 model and score the
    held-out images through ``Evaluator`` (tiles ``crop``²); with
    ``replica``, the reference replica scores them too. Returns the losses,
    the card's and the host's s/step, the training's peak memory and its
    kernel launches, the evaluation's launches, both meanIUs, the argmax
    agreement and the two ``gamma`` readings."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = TrainConfig(model="ccnet", depth=depth, recurrence=2, input_size=(crop, crop),
                      batch_size=batch, num_steps=steps, save_every=steps, ohem=True,
                      ohem_keep=30000, snapshot_dir=snap_dir, log_every=50,
                      learning_rate=5e-3, impl=impl, device=device)
    loader = DataLoader(LearnableDS(hw=hw), batch, shuffle=True, num_workers=2)
    before = launch_counts()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trained = Trainer(cfg).run(loader)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    after = launch_counts()
    train_launches = {n: after[n] - before[n] for n in after}

    pth = os.path.join(snap_dir, f"CS_scenes_{steps}.pth")
    model = build_model("ccnet", num_classes=NUM_CLASSES, recurrence=2, depth=depth,
                        dtype=torch.bfloat16, impl=impl, device=dev)
    load_pth(pth, model, strict=True)
    ev = Evaluator(lambda x: model(x)["main"], num_classes=NUM_CLASSES, tile_hw=(crop, crop),
                   device=dev)
    held = LearnableDS(n=HELD_OUT, hw=hw, seed=1000)
    samples = [held[i] for i in range(len(held))]
    scored = ev.run([(img[None], lbl[None], [name]) for img, lbl, name in samples])
    port_preds = [ev.predict_batch(img[None])[0] for img, _, _ in samples]
    after_eval = launch_counts()
    result = {
        "depth": depth, "steps": steps, "batch": batch, "crop": crop, "hw": list(hw),
        "impl": impl, "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "pth": pth, "losses": trained["losses"], "step_seconds": trained["step_seconds"],
        "wall_seconds": trained["wall_seconds"], "train_seconds": train_s, "peak_bytes": peak,
        "train_launches": train_launches,
        "eval_launches": {n: after_eval[n] - after[n] for n in after},
        "port_miou": scored["meanIU"],
        "gamma_port": float(model.head.cca.gamma.item()),
        "replica_miou": None, "gamma_replica": None, "agreement": None,
    }
    del model, ev
    if cuda:
        torch.cuda.empty_cache()
    if replica:
        preds, result["gamma_replica"] = replica_predict(pth, depth, [s[0] for s in samples], dev)
        cm = sum(_confusion(lbl, p) for (_, lbl, _), p in zip(samples, preds))
        result["replica_miou"] = iou_from_confusion(cm)[1]
        same = sum(int((p == q)[lbl != 255].sum())
                   for (_, lbl, _), p, q in zip(samples, preds, port_preds))
        result["agreement"] = same / sum(int((s[1] != 255).sum()) for s in samples)
    report(result)
    return result


def report(r: dict) -> None:
    dev, wall = np.asarray(r["step_seconds"][1:]), np.asarray(r["wall_seconds"][1:])
    tag = (f"CCNet R{r['depth']} R=2 bf16 OHEM impl={r['impl']} bs {r['batch']} "
           f"{r['crop']}x{r['crop']}, {r['steps']} steps on {r['device']}")
    losses = r["losses"]
    log(f"[e2e] {tag}: losses first {losses[0]:.4f}, last {losses[-1]:.4f}; "
        + (f"steps 2-{r['steps']}: augment + step {dev.mean():.4f} s/step (CUDA events on a "
           f"card, the host clock on the CPU; median {np.median(dev):.4f}), host wall "
           f"{wall.mean():.4f} s/step (the loader's wait included; median "
           f"{np.median(wall):.4f}); " if len(dev) else "")
        + f"{r['train_seconds']:.1f} s in all"
        + (f"; peak memory {r['peak_bytes'] / 2**30:.2f} GiB" if r["peak_bytes"] else ""))
    log(f"[e2e] training launches {({n: c for n, c in r['train_launches'].items() if c})}, "
        f"evaluation launches {({n: c for n, c in r['eval_launches'].items() if c})}")
    log(f"[e2e] held-out meanIU (ccnet_tpu_torch, R{r['depth']}): {r['port_miou']:.4f}; "
        f"trained gamma {r['gamma_port']:.4e}")
    if r["replica_miou"] is not None:
        log(f"[e2e] held-out meanIU (torch replica,   R{r['depth']}): {r['replica_miou']:.4f}; "
            f"gamma as it reads it {r['gamma_replica']:.4e}; argmax agreement with the port "
            f"{r['agreement']:.6f} of the valid pixels (sliding bf16 vs whole f32)")


def require_bar(result: dict, **recipe) -> None:
    """Raise unless ``result`` scores meanIU > MIN_MIOU through the port and,
    where it ran, the replica. Before raising, :func:`run` the same
    ``recipe`` on the plain route (``impl="torch"``, its own snapshot
    directory) and put its meanIU beside the kernel route's."""
    scores = [result["port_miou"]] + ([result["replica_miou"]]
                                      if result["replica_miou"] is not None else [])
    if all(s > MIN_MIOU for s in scores):
        return
    snap = recipe.pop("snap_dir", "snapshots_e2e") + "_plain"
    plain = run(**{**recipe, "impl": "torch", "replica": False, "snap_dir": snap})
    raise AssertionError(
        f"held-out meanIU <= {MIN_MIOU}: " + ", ".join(
            f"{who} {s:.4f}" for who, s in zip(("port", "replica"), scores))
        + f" on impl={result['impl']}; the plain route's port {plain['port_miou']:.4f}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    depth = int(os.environ.get("E2E_DEPTH", "101"))
    steps = int(os.environ.get("E2E_STEPS", str(STEPS)))
    with tempfile.TemporaryDirectory() as tmp:
        recipe = dict(depth=depth, steps=steps, device=args.device,
                      snap_dir=os.path.join(tmp, "snap"),
                      replica=not os.environ.get("E2E_SKIP_TORCH"))
        result = run(**recipe)
        require_bar(result, **recipe)
    log(json.dumps({k: v for k, v in result.items()
                    if k not in ("losses", "step_seconds", "wall_seconds")}))
    log("E2E LOOP OK")
    return result


if __name__ == "__main__":
    main()
