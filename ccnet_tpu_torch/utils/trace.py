"""Spans and counters at the port's layer boundaries.

* :func:`span` names a stretch of host time ``ccnet.<name>`` in a
  ``torch.profiler`` trace: a ``record_function`` range, entered only while
  a profiler is recording (under a profiler's ``schedule``, in its active
  steps), so the range lands in the same trace and on the same clock as the
  device's kernels and copies. With no profiler on it costs one flag check.
* :func:`count` adds to :data:`COUNTS`, always on, as the kernels' launch
  counters (``ops.launch_counts()``) are; :func:`counts` returns a copy.
  The port counts ``train.steps`` and ``serve.requests``, every collective
  it issues (``collective.<kind>.calls`` and ``.bytes``, through
  :func:`collective`), and every blocking transfer between the host and a
  CUDA card on the train and serving paths (``sync.<site>``, through
  :func:`sync`), so readers can form ratios per step or request.

The spans, each where its work happens: ``train.augment``
(``Trainer._augment``), ``train.forward``, ``train.loss``,
``train.backward``, ``train.optimizer`` (``train/step.py``),
``train.loader_wait`` (``Trainer._run``), ``serve.place``, ``serve.fetch``
(``Evaluator.predict_batch``) and ``collective.<kind>`` around each
``all_reduce`` (``parallel/``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.autograd import profiler as _profiler

COUNTS: dict = {}
_LOCK = threading.Lock()  # counted from the main, autograd and prefetch threads
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler range ``ccnet.<name>`` while a
    profiler records, else nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(f"ccnet.{name}")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n


def counts() -> dict:
    """A copy of every counter."""
    with _LOCK:
        return dict(COUNTS)


def collective(kind: str, nbytes: int):
    """Count one collective of ``kind`` carrying ``nbytes`` and return its
    span, ``collective.<kind>``."""
    count(f"collective.{kind}.calls")
    count(f"collective.{kind}.bytes", nbytes)
    return span(f"collective.{kind}")


def crosses(device) -> bool:
    """Whether a copy between the host and ``device`` crosses to a card."""
    return torch.device(device).type == "cuda"


def sync(site: str, device, n: int = 1) -> None:
    """Count ``n`` blocking transfers at ``site`` between the host and
    ``device``; none where ``device`` is the host."""
    if crosses(device):
        count(f"sync.{site}", n)
