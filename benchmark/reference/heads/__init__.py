"""The main heads of the reference networks, one file a model.

``heads/<model>.py`` holds the head of every configuration whose
``"model"`` is ``<model>``, and exports one function::

    head(config: dict) -> torch.nn.Module

The module takes layer4's 2048-channel feature at output stride 8 and
returns the main logits (``num_classes`` channels at the same stride). It
is plain torch in f32 built from the shared blocks of
:mod:`benchmark.reference.models` (``Conv2d``, ``ABN``, ``MaskedDropout``
with the channel count it drops, :func:`~benchmark.reference.models.operand`
around any other product), so the fp8 control covers it, and its module
names are the port's, so the program's state dict loads into it under
``head.*``. Like the rest of the reference it imports nothing of the
program.
"""
