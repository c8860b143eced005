"""REST inference server (counterpart of ``neuralmonkey_tpu/server.py``,
reference nm/server.py and bin/neuralmonkey-server).

The same JSON API as the JAX package's, from the standard library:

    POST /run    {"source": ["raw sentence", ...], ...}
                 -> {"target": [["decoded", "tokens"], ...], ...}
    GET  /       health/info

Input values may be raw strings (split on whitespace) or pre-tokenized
lists. The model is built and restored once at startup; each model call
is an in-memory Dataset through ``Experiment.run_model``, on the card
unless the INI's ``[tf_manager]`` asks for the CPU.

Dynamic request micro-batching: a request enqueues and one worker thread
drains the queue, waiting up to ``batch_window_ms`` after the first
pending request for stragglers, merges the payloads with the same series
names into one dataset, runs the model once and splits the outputs back
per request. Batch padding is inert (masks), so merged answers equal
per-request ones: identically on the CPU; on the card a different batch
composition sums the logits in another order, which can flip a near-tie
beam decision, as the JAX package notes for its TPU.
``batch_window_ms=0`` still merges what is already queued.

The worker is the thread that launches the kernels. It runs every model
call in ``torch.inference_mode()`` of its own (the mode is per thread),
on the current stream of its own thread, and each launch's status is
read on that thread. An error in a model call (a kernel's build or
launch error among them) fails the requests of that call with the error;
an error that ends the worker fails every pending request; no request
waits forever and no error is swallowed. ``close()`` joins the worker.

Usage: python -m neuralmonkey_tpu_torch.server --configuration exp.ini
           [checkpoint] [--port 5000] [--batch-window-ms 10]
           [--max-batch 256]
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import torch

from .dataset import from_dict
from .experiment import Experiment
from .logging import log, warn


class _PendingRequest:
    """One enqueued payload awaiting the batching worker."""

    __slots__ = ("series", "rows", "event", "outputs", "error")

    def __init__(self, series: Dict[str, List], rows: int) -> None:
        self.series = series
        self.rows = rows
        self.event = threading.Event()
        self.outputs: Optional[Dict[str, List]] = None
        self.error: Optional[BaseException] = None


class ModelService:
    """Holds the experiment; merges concurrent requests into one model
    call (see the module docstring). ``stats`` counts requests, model
    calls and the merged requests and rows of each call."""

    def __init__(self, experiment: Experiment,
                 batch_window_ms: float = 10.0,
                 max_batch: int = 256) -> None:
        self.experiment = experiment
        self.batch_window_ms = batch_window_ms
        self.max_batch = max_batch
        self.stats = {"requests": 0, "model_calls": 0,
                      "max_merged_requests": 0, "max_merged_rows": 0,
                      "merged_requests_total": 0, "merged_rows_total": 0}
        self._cond = threading.Condition()
        self._queue: List[_PendingRequest] = []
        self._closed = False
        self._worker = threading.Thread(
            target=self._serve_loop, name="nm-microbatcher", daemon=True)
        self._worker.start()

    # -------------------------------------------------------------- #
    def run(self, payload: Dict[str, List]) -> Dict[str, List]:
        """Validate and tokenize, enqueue, and wait until the worker has
        answered the request. Called from the handler threads."""
        if not isinstance(payload, dict):
            raise ValueError("The request must be a JSON object of series")
        series: Dict[str, List] = {}
        rows = None
        for name, sentences in payload.items():
            if not isinstance(sentences, list):
                raise ValueError(f"Series '{name}' must be a list")
            tokenized = [s.split() if isinstance(s, str) else list(s)
                         for s in sentences]
            if rows is None:
                rows = len(tokenized)
            elif len(tokenized) != rows:
                raise ValueError(
                    "All series in one request must have the same "
                    f"number of sentences ('{name}' has {len(tokenized)}, "
                    f"expected {rows})")
            series[name] = tokenized
        if not series or not rows:
            return {}

        pending = _PendingRequest(series, rows)
        with self._cond:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self.stats["requests"] += 1
            self._queue.append(pending)
            self._cond.notify_all()
        pending.event.wait()
        if pending.error is not None:
            raise pending.error
        return pending.outputs

    def close(self) -> None:
        """Stop taking requests, answer the queued ones, and join the
        worker (a worker left in a model call would race the teardown of
        the device)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker.is_alive():
            self._worker.join(timeout=60.0)
            if self._worker.is_alive():
                warn("micro-batch worker did not stop within 60 s; a model "
                     "call may still be in flight")

    # -------------------------------------------------------------- #
    def _take_group(self) -> List[_PendingRequest]:
        """Pop the longest run at the head of the queue whose requests
        have the first one's series names, up to ``max_batch`` rows
        (first come first served; the rest wait for the next call)."""
        keys = frozenset(self._queue[0].series)
        group: List[_PendingRequest] = []
        rows = 0
        while self._queue:
            nxt = self._queue[0]
            if frozenset(nxt.series) != keys:
                break
            if group and rows + nxt.rows > self.max_batch:
                break
            group.append(self._queue.pop(0))
            rows += nxt.rows
        return group

    def _serve_loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._closed:
                        self._cond.wait()
                    if self._closed and not self._queue:
                        return
                    # the window: wait for stragglers after the first
                    # request (not at 0 ms, nor once the batch is full)
                    deadline = time.monotonic() + self.batch_window_ms / 1e3
                    while (not self._closed
                           and sum(p.rows for p in self._queue)
                           < self.max_batch):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                    group = self._take_group()
                self._execute(group)
        except BaseException as exc:
            # the handlers wait on their events with no timeout: a worker
            # that dies must answer every request still queued
            with self._cond:
                self._closed = True
                orphans = list(self._queue)
                self._queue.clear()
                self._cond.notify_all()
            for pending in orphans:
                pending.error = RuntimeError(
                    f"batching worker crashed: {exc!r}")
                pending.event.set()
            raise

    def _execute(self, group: List[_PendingRequest]) -> None:
        merged: Dict[str, List] = {name: [] for name in group[0].series}
        for pending in group:
            for name, sentences in pending.series.items():
                merged[name].extend(sentences)
        rows = sum(p.rows for p in group)
        self.stats["model_calls"] += 1
        self.stats["merged_requests_total"] += len(group)
        self.stats["merged_rows_total"] += rows
        self.stats["max_merged_requests"] = max(
            self.stats["max_merged_requests"], len(group))
        self.stats["max_merged_rows"] = max(self.stats["max_merged_rows"],
                                            rows)
        try:
            self._run_split(merged, group)
        except Exception as exc:  # pylint: disable=broad-except
            if len(group) == 1:
                group[0].error = exc
            else:
                # one bad request must not fail the merged group: each is
                # run alone, so only the offender gets its error
                for pending in group:
                    try:
                        self._run_split(pending.series, [pending])
                    except Exception as solo:  # pylint: disable=broad-except
                        pending.error = solo
        except BaseException as exc:
            # SystemExit or KeyboardInterrupt out of the model call: the
            # finally answers this group, with an error, and the worker's
            # handler fails the requests still queued
            for pending in group:
                pending.error = RuntimeError(
                    f"batching worker crashed: {exc!r}")
            raise
        finally:
            for pending in group:
                pending.event.set()

    def _run_split(self, merged: Dict[str, List],
                   group: List[_PendingRequest]) -> None:
        """One model call over ``merged``, in inference mode on this
        thread; each output series split back per request by rows."""
        total_rows = sum(p.rows for p in group)
        dataset = from_dict(merged, name="request")
        with torch.inference_mode():
            _, outputs = self.experiment.run_model(dataset)
        clean = {}
        for name, data in outputs.items():
            if len(data) != total_rows:
                raise RuntimeError(
                    f"output series '{name}' has {len(data)} items for "
                    f"{total_rows} input sentences; cannot split a merged "
                    "batch")
            clean[name] = [
                item if isinstance(item, (list, str, float, int))
                else getattr(item, "tolist", lambda: str(item))()
                for item in data]
        offset = 0
        for pending in group:
            pending.outputs = {name: data[offset:offset + pending.rows]
                               for name, data in clean.items()}
            offset += pending.rows


def make_handler(service: ModelService):

    class Handler(BaseHTTPRequestHandler):

        def _send(self, code: int, body: Dict) -> None:
            payload = json.dumps(body).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802 (http.server API)
            self._send(200, {
                "status": "ok",
                "service": "neuralmonkey_tpu_torch",
                "usage": "POST /run with JSON {series_name: "
                         "[sentences...]}"})

        def do_POST(self):  # noqa: N802
            if self.path.rstrip("/") not in ("", "/run", "/translate"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length).decode("utf-8"))
                result = service.run(payload)
            except Exception as exc:  # pylint: disable=broad-except
                # the request's error goes back to its client as JSON
                warn(f"Request failed: {exc!r}")
                self._send(400, {"error": str(exc)})
                return
            self._send(200, result)

        def log_message(self, fmt, *args):
            log(f"server: {fmt % args}")

    return Handler


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="neuralmonkey_tpu_torch.server")
    parser.add_argument("--configuration", "-c", required=True,
                        help="experiment INI file")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("checkpoints", nargs="*",
                        help="checkpoint path (one; ensembles are not "
                             "ported yet)")
    parser.add_argument("--average", action="store_true",
                        help="average several checkpoints (not ported "
                             "yet)")
    parser.add_argument("--batch-window-ms", type=float, default=10.0,
                        help="how long to wait for more requests after "
                             "the first pending one (0: no wait, still "
                             "merges what is queued)")
    parser.add_argument("--max-batch", type=int, default=256,
                        help="most merged sentences a model call")
    args = parser.parse_args(argv)
    if args.average or len(args.checkpoints) > 1:
        raise NotImplementedError(
            "several checkpoints (an ensemble or --average) are not ported "
            "to neuralmonkey_tpu_torch yet (ROADMAP queue A14)")

    exp = Experiment(args.configuration, train_mode=False)
    exp.build_model()
    exp.restore_variables(args.checkpoints or None)
    service = ModelService(exp, batch_window_ms=args.batch_window_ms,
                           max_batch=args.max_batch)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    log(f"Serving on http://{args.host}:{args.port} (POST /run)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        log("Server stopped.")
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
