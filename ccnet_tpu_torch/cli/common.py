"""Shared CLI plumbing. Counterpart of :mod:`ccnet_tpu.cli.common`; the
multi-device flags (``--data-parallel``, ``--space``) are checked in the
entry points, which run on one device until the multi-GPU port."""

from __future__ import annotations


def str2bool(v) -> bool:
    return str(v).lower() in ("yes", "true", "t", "1")
