"""The port's HTTP server (``neuralmonkey_tpu_torch/server.py``) on the
CPU, modelled on tests/test_rl_and_server.py.

small.ini's model is built on the CPU with weights drawn from numpy and
saved as one checkpoint. Over it: a round trip through
``ThreadingHTTPServer``; a malformed request gets a 400 and the server
stays up; an error in a model call reaches its client as a 400 with the
message; concurrent requests merge into fewer model calls and each
answer equals its own request's alone (identically on the CPU); a crash
of the worker fails every pending request; ``close()`` joins the
worker; and the port's ``ModelService`` gives the JAX package's greedy
ids on the same checkpoint.
"""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch import server
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.utils.saving import flatten_tree

torch.set_num_threads(2)
CONFIG = os.path.join(os.path.dirname(__file__), "configs", "small.ini")
SENTENCES = ["one two three", "nine eight", "five five four", "two",
             "seven six five four", "eight one", "three three",
             "four nine two one"]


def _experiment(tmp_path):
    return Experiment(CONFIG, train_mode=False, config_changes=[
        'tf_manager.device="cpu"', f'main.output="{tmp_path / "out"}"'])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """small.ini's parameters drawn from numpy (scale 0.3, so the greedy
    decodes vary from sentence to sentence) as one ``.npz``."""
    tmp = tmp_path_factory.mktemp("ckpt")
    exp = _experiment(tmp)
    exp.build_model()
    rng = np.random.RandomState(0)
    flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in flatten_tree(exp.tf_manager.params).items()}
    path = str(tmp / "variables.npz")
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return path


def _service(tmp_path, checkpoint, **kwargs):
    exp = _experiment(tmp_path)
    exp.build_model()
    exp.restore_variables([checkpoint])
    return server.ModelService(exp, **kwargs)


class _Http:
    """A ThreadingHTTPServer over a service on a free local port."""

    def __init__(self, service):
        self.service = service
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         server.make_handler(service))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, body: bytes):
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/run", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def run(self, payload):
        return self.post(json.dumps(payload).encode())

    def close(self):
        self.service.close()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def test_server_round_trip(tmp_path, checkpoint):
    http = _Http(_service(tmp_path, checkpoint))
    try:
        body = http.run({"source": ["one two three", "nine eight"]})
        assert len(body["target"]) == 2
        assert all(isinstance(s, list) for s in body["target"])
        assert body["target"] == http.run(
            {"source": [["one", "two", "three"], ["nine", "eight"]]})["target"]
        with urllib.request.urlopen(f"http://127.0.0.1:{http.port}/",
                                    timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["status"] == "ok"
        assert info["service"] == "neuralmonkey_tpu_torch"
    finally:
        http.close()


@pytest.mark.parametrize("body,message", [
    (b"not json", "Expecting value"),
    (b'{"source": "one two"}', "must be a list"),
    (b'{"source": ["a"], "target": ["b", "c"]}', "same number"),
    (b'["one two"]', "JSON object"),
])
def test_malformed_request_gets_400_and_the_server_stays_up(
        tmp_path, checkpoint, body, message):
    http = _Http(_service(tmp_path, checkpoint))
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            http.post(body)
        assert err.value.code == 400
        assert message in json.loads(err.value.read())["error"]
        assert len(http.run({"source": ["two"]})["target"]) == 1
    finally:
        http.close()


def test_model_call_error_reaches_its_client(tmp_path, checkpoint,
                                             monkeypatch):
    """An error raised inside the model call (a kernel's launch error on
    the card) is the client's 400, with its message, and the worker
    serves the next request."""
    service = _service(tmp_path, checkpoint)
    real = service.experiment.run_model
    calls = []

    def failing(dataset, *args, **kwargs):
        calls.append(dataset)
        if len(calls) == 1:
            raise RuntimeError("flash_attention_fwd: launch failed with CUDA "
                               "error 1 (invalid argument)")
        return real(dataset, *args, **kwargs)
    monkeypatch.setattr(service.experiment, "run_model", failing)
    http = _Http(service)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            http.run({"source": ["one"]})
        assert err.value.code == 400
        assert "launch failed with CUDA error 1" in json.loads(
            err.value.read())["error"]
        assert len(http.run({"source": ["one"]})["target"]) == 1
    finally:
        http.close()


def test_merged_answers_equal_single_requests(tmp_path, checkpoint):
    """Concurrent requests merge into fewer model calls (a mean of at
    least two requests a call under a 2 s window), and each answer is
    its sentence's own decode, identically."""
    service = _service(tmp_path, checkpoint, batch_window_ms=0.0)
    http = _Http(service)
    try:
        reference = {s: http.run({"source": [s]})["target"][0]
                     for s in SENTENCES}
        assert len({tuple(t) for t in reference.values()}) > 1
        calls_before = service.stats["model_calls"]
        merged_before = service.stats["merged_requests_total"]
        service.batch_window_ms = 2000.0
        results, errors = {}, []

        def client(sentence):
            try:
                results[sentence] = http.run({"source": [sentence]})[
                    "target"][0]
            except Exception as exc:  # pragma: no cover
                errors.append(exc)
        threads = [threading.Thread(target=client, args=(s,))
                   for s in SENTENCES]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors
        calls = service.stats["model_calls"] - calls_before
        merged = service.stats["merged_requests_total"] - merged_before
        assert calls <= len(SENTENCES) // 2, calls
        assert merged / max(calls, 1) >= 2.0, service.stats
        assert service.stats["max_merged_requests"] > 1
        assert results == reference
    finally:
        http.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_fails_every_pending_request(tmp_path, checkpoint,
                                                  monkeypatch):
    """A BaseException out of a model call ends the worker: its own group
    and every request still queued get an error; none waits forever,
    and the service takes no more requests."""
    service = _service(tmp_path, checkpoint, batch_window_ms=0.0)
    entered, release = threading.Event(), threading.Event()

    def crashing(dataset, *args, **kwargs):
        entered.set()
        release.wait(timeout=60)
        raise SystemExit("device lost")
    monkeypatch.setattr(service.experiment, "run_model", crashing)
    errors = {}

    def client(name, series):
        try:
            service.run(series)
        except Exception as exc:  # each client must get an error
            errors[name] = exc
    first = threading.Thread(target=client, args=("first", {"source": ["a"]}))
    first.start()
    assert entered.wait(timeout=60)
    # a request with another series set is queued behind the crash
    queued = [threading.Thread(target=client, args=(n, s)) for n, s in (
        ("second", {"source": ["b"]}),
        ("third", {"source": ["c"], "target": ["d"]}))]
    for t in queued:
        t.start()
    while service.stats["requests"] < 3:
        threading.Event().wait(0.01)
    release.set()
    for t in [first] + queued:
        t.join(timeout=60)
        assert not t.is_alive()
    assert set(errors) == {"first", "second", "third"}
    assert all("batching worker crashed" in str(e) for e in errors.values())
    service._worker.join(timeout=60)
    assert not service._worker.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        service.run({"source": ["e"]})


def test_close_joins_the_worker(tmp_path, checkpoint):
    service = _service(tmp_path, checkpoint)
    assert service.run({"source": ["one"]})["target"]
    assert service._worker.is_alive()
    service.close()
    assert not service._worker.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        service.run({"source": ["one"]})


def test_main_refuses_several_checkpoints(checkpoint):
    with pytest.raises(NotImplementedError, match="A14"):
        server.main(["--configuration", CONFIG, checkpoint, checkpoint])
    with pytest.raises(NotImplementedError, match="A14"):
        server.main(["--configuration", CONFIG, "--average", checkpoint])


def test_greedy_ids_match_the_jax_service(tmp_path, checkpoint):
    """One checkpoint, small.ini's model: the port's service and the JAX
    package's give the same greedy decodes for the same requests."""
    from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
    from neuralmonkey_tpu.server import ModelService as JaxModelService
    jax_exp = JaxExperiment(CONFIG, train_mode=False, config_changes=[
        f'main.output="{tmp_path / "jax"}"'])
    jax_exp.build_model()
    jax_exp.restore_variables([checkpoint])
    jax_service = JaxModelService(jax_exp, batch_window_ms=0.0)
    service = _service(tmp_path, checkpoint, batch_window_ms=0.0)
    try:
        payload = {"source": SENTENCES}
        assert service.run(payload) == jax_service.run(payload)
    finally:
        service.close()
        jax_service.close()
