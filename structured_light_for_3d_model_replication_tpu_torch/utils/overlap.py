"""A one-task pipelined executor for the finalize tail (counterpart of the
JAX ``utils/overlap.py``).

Once a scan's merged cloud exists, its mesh solve shares no data with the
rest of the finalize work (pose table, health, stats). A
:class:`PipelinedTask` runs ONE callable on a background thread while the
caller finishes that tail, then joins deterministically: ``result()`` blocks
until the worker is done and re-raises its exception in the caller's frame.

* Determinism: the worker runs the same callable with the same arguments
  the sequential path would; overlap changes when the work runs, not what.
* Context: the submitter's ``contextvars`` context is copied into the
  worker. PyTorch's current CUDA device and current stream are per thread,
  so both are captured at submit and re-entered in the worker: its kernels
  go onto the caller's stream, after everything the caller queued before
  the submit, so the worker sees the caller's finished tensors, and the
  caller sees the worker's results once it has joined.
* Containment: a worker exception is carried to ``result()``.
"""

from __future__ import annotations

import contextvars
import threading
import time

import torch


class PipelinedTask:
    """Run ``fn(*args, **kwargs)`` on a daemon thread; join with
    :meth:`result`. ``timings()`` gives the start and end instants relative
    to the submit (``time.monotonic`` seconds)."""

    def __init__(self, fn, *args, name: str = "task", **kwargs):
        self.name = str(name)
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None
        self.t_submit = time.monotonic()
        self.t_start: float | None = None
        self.t_end: float | None = None
        ctx = contextvars.copy_context()
        stream = torch.cuda.current_stream() \
            if torch.cuda.is_available() and torch.cuda.is_initialized() \
            else None

        def _call():
            if stream is None:
                return fn(*args, **kwargs)
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                return fn(*args, **kwargs)

        def _run():
            self.t_start = time.monotonic()
            try:
                self._result = ctx.run(_call)
            except BaseException as exc:  # re-raised at result()
                self._exc = exc
            finally:
                self.t_end = time.monotonic()
                self._done.set()

        self._thread = threading.Thread(target=_run,
                                        name=f"overlap-{self.name}",
                                        daemon=True)
        self._thread.start()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        """Block until the worker finished; return its value or re-raise its
        exception here. An expired ``timeout`` raises :class:`TimeoutError`
        and leaves the worker running."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"PipelinedTask({self.name!r}) still running after "
                f"{timeout:.1f}s")
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._result

    def timings(self) -> dict:
        """Start and end (seconds since submit); None while unknown."""
        t0 = self.t_submit
        return {
            "started_s": None if self.t_start is None
            else round(self.t_start - t0, 6),
            "ended_s": None if self.t_end is None
            else round(self.t_end - t0, 6),
        }
