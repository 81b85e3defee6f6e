"""Named spans of the port's two hot paths, recorded by whatever
``torch.profiler`` session is running and free when none is.

    with span("harness.land", batch_no):
        ...

records the user annotation ``hspose.harness.land`` into the running
profiler's buffer, on the clock of its device trace, so that an idle gap
of the card can be put down to what the host was doing.  There is no
switch: the spans are on exactly while a profiler session is on (the
benchmark's traced passes, the train CLI's ``HSPOSE_PROFILE_DIR`` window,
an operator's own ``torch.profiler.profile``), and whoever runs the
profiler writes them out with the rest of its trace.  With no profiler
running, ``span`` returns one shared no-op context after one flag check.

``ident``, an integer (a batch number), is recorded as the span's input,
so that the spans of one batch share it in the exported trace; the
profiler keeps it when it records shapes (``record_shapes=True``: the
event's ``concrete_inputs``, "Concrete Inputs" in a Chrome trace).

The spans, by path:

* serving (``evaluation/evaluate.py::batched_pose_inference``):
  ``hspose.harness.request`` (one a call), inside it
  ``hspose.harness.ingest`` (one a record: pull it and copy its crops into
  the pending lists; one more for the pull that finds the end),
  ``hspose.harness.to_device`` (stack, pad, cast and copy every input of
  one batch; ident the batch), ``hspose.harness.forward`` (enqueue the
  batch's forward; ident the batch), inside it
  ``hspose.model.eval_forward`` and ``hspose.model.generate_RT``, and
  ``hspose.harness.land`` (fetch a batch's outputs and fill its records;
  ident the batch it lands, the one before the last submitted);
* a forward served as a CUDA graph (``models/graphed.py``), inside
  ``hspose.model.eval_forward``: ``hspose.model.graph_capture`` (one a
  capture, the eager warm-up forwards included; ident the model's count of
  captures, from 0), then ``hspose.model.graph_replay`` (copy the inputs
  in, replay, clone the outputs); the eager route records neither;
* training (``engine/train_step.py``): ``hspose.train.step`` (one a
  step), inside it ``hspose.train.forward`` (augmentation, posenet,
  losses), ``hspose.train.backward`` (on the calling thread),
  ``hspose.train.metrics`` (the metrics' fetches), and the optimizer's
  own ``Optimizer.step#Ranger.step``, which ``torch.optim.Optimizer``
  records;
* ``hspose.sync.<site>`` around every read that makes the host wait for
  the card, nested in its caller's span: ``upload`` (each pageable
  host-to-device copy: ``to_device``'s inputs where the device is not a
  CUDA card, whose copies come from pinned memory and do not wait, and in
  the train forward the Python-list indices and host constants it copies
  to the card),
  ``solve`` (``torch.linalg.solve``'s error check in the plane fits),
  ``fetch`` (each output's ``.cpu()`` in ``land``), ``finite`` (the NaN
  guard, and with ``train.debug_nan`` each term's check), ``clip``
  (Ranger's clip decision), ``total`` and ``term`` (the metrics'
  ``float()``).  Their count is the number of such reads, their
  durations the host's wait.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "hspose."
OFF = contextlib.nullcontext()  # the shared no-op while no profiler runs


class _Span:
    """One user annotation of the running profiler, with its ident as input."""

    __slots__ = ("_args", "_handle")

    def __init__(self, args: tuple):
        self._args = args

    def __enter__(self):
        self._handle = torch.autograd._record_function_with_args_enter(*self._args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self._handle)
        return False


def span(name: str, ident: Optional[int] = None):
    """The span ``hspose.<name>`` while a profiler runs, else ``OFF``."""
    if not torch.autograd._profiler_enabled():
        return OFF
    return _Span((PREFIX + name,) if ident is None else (PREFIX + name, ident))
