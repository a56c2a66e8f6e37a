"""ccnet_tpu_torch — the PyTorch + CUDA port of :mod:`ccnet_tpu` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module layout
and names so each counterpart is found by path. It imports ``torch`` and
never ``jax``:

* models are ``nn.Module``\\ s in NCHW (:mod:`ccnet_tpu_torch.models`);
* criss-cross attention has a plain-torch version
  (:mod:`ccnet_tpu_torch.ops.cc_attention`) and hand-written CUDA forward
  kernels for ``sm_90a`` (:mod:`ccnet_tpu_torch.ops.cc_attention_cuda`,
  sources under ``csrc/``), built with ``nvcc`` at first use;
* evaluation (sliding window, whole image, multi-scale + flip) runs under
  ``torch.inference_mode()`` on an explicit device
  (:mod:`ccnet_tpu_torch.evaluation`).

Entry points: ``python -m ccnet_tpu_torch.cli.train`` (Cityscapes or VOC),
``cli.evaluate``, ``cli.predict`` (test-set submission PNGs) and
``cli.probe``; over N cards, one process each under torchrun
(:mod:`ccnet_tpu_torch.parallel`).
"""

__version__ = "0.1.0"
