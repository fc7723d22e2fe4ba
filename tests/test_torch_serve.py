"""The PyTorch port's serving slice end to end, against the JAX package,
on the CPU: train with JAX, carry the model and its binned training set
across with ``booster_from_reference``, then compare ``Booster.predict``,
``PredictSession.predict`` / ``predict_binned``, a ``MicroBatcher`` round
and loopback HTTP ``/predict`` with JAX at RTOL/ATOL (f32 sums in another
order).
"""
import json
import threading
import urllib.request

import numpy as np
import pytest

from torch_port_cases import ATOL, CPU, RTOL, train_case

import lightgbm_tpu as lgb
from lightgbm_tpu.serve import PredictSession as JaxSession

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.ops.forest import FOREST_KERNEL
from lightgbm_tpu_torch.ops.route import ROUTE_KERNEL
from lightgbm_tpu_torch.serve import (MicroBatcher, PredictServer,
                                      PredictSession)
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    return train_case("binary", tmp_path_factory.mktemp("serve"),
                      rounds=8, n_query=600)


def test_booster_predict_matches_jax(binary):
    bst, port, Xq, _ = binary
    for raw in (False, True):
        np.testing.assert_allclose(port.predict(Xq, raw_score=raw),
                                   bst.predict(Xq, raw_score=raw),
                                   rtol=RTOL, atol=ATOL)
    # small batches walk the host trees in both packages
    np.testing.assert_allclose(port.predict(Xq[:10]), bst.predict(Xq[:10]),
                               rtol=RTOL, atol=ATOL)
    assert port.num_feature() == bst.num_feature()


def test_session_predict_and_binned_match_jax(binary, tmp_path):
    bst, port, Xq, path = binary
    ref = JaxSession(bst).predict(Xq)
    obs.telemetry.reset()
    sess = PredictSession(port)
    np.testing.assert_allclose(sess.predict(Xq), ref, rtol=RTOL, atol=ATOL)
    assert obs.telemetry.counter("serve/forest_dispatches") == 1
    # BIN-space path over a dataset binned with the training mappers
    jref = JaxSession(bst).predict_binned(
        lgb.Dataset(Xq, reference=lgb.Dataset(path)))
    got = sess.predict_binned(lgt.Dataset(Xq, reference=lgt.Dataset(path)))
    np.testing.assert_allclose(got, jref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    # on the CPU the kernels' plain twins ran: nothing was launched
    assert FOREST_KERNEL.launches == 0 and ROUTE_KERNEL.launches == 0


@pytest.mark.parametrize("mode", ["continuous", "coalesce"])
def test_microbatcher_round_matches_jax(binary, mode):
    bst, port, Xq, _ = binary
    ref = JaxSession(bst).predict(Xq)
    sess = PredictSession(port, buckets=(64, 256, 1024))
    with MicroBatcher(sess, max_batch_rows=512, dispatch_mode=mode) as mb:
        futs = [mb.submit(Xq[i:i + 20]) for i in range(0, 600, 20)]
        outs = [f.result(timeout=60) for f in futs]
        assert mb.latency_stats()["count"] == len(futs)
    np.testing.assert_allclose(np.concatenate(outs), ref,
                               rtol=RTOL, atol=ATOL)


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_predict_matches_jax(binary):
    bst, port, Xq, _ = binary
    ref = JaxSession(bst).predict(Xq[:50])
    server = PredictServer(port, port=0, buckets=(64, 256))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        host, p = server.address
        base = "http://%s:%d" % (host, p)
        doc = _post(base + "/predict", {"rows": Xq[:50].tolist()})
        assert doc["rows"] == 50
        assert doc["model_version"] == port.inner.model_version
        np.testing.assert_allclose(doc["predictions"], ref,
                                   rtol=RTOL, atol=ATOL)
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        with urllib.request.urlopen(base + "/models", timeout=30) as r:
            assert json.loads(r.read()) == {"models": ["default"]}
        try:
            _post(base + "/predict/nope", {"rows": [[0.0] * 8]})
            raise AssertionError("unknown model id must 404")
        except urllib.error.HTTPError as exc:
            assert exc.code == 404
    finally:
        server.shutdown()
        server.close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_model_text_round_trips(binary):
    bst, port, Xq, _ = binary
    assert port.model_to_string() == bst.model_to_string()
    again = lgt.Booster(params=CPU, model_str=port.model_to_string())
    np.testing.assert_allclose(again.predict(Xq), bst.predict(Xq),
                               rtol=RTOL, atol=ATOL)


def test_adopt_and_restore_bump_version(binary, tmp_path):
    bst, port, Xq, path = binary
    sess = PredictSession(port)
    before = sess.predict(Xq)
    v0 = port.inner.model_version
    other = lgt.booster_from_reference(
        bst.model_to_string(num_iteration=3), path, CPU)
    token = port.adopt(other)
    assert port.inner.model_version == v0 + 1
    np.testing.assert_allclose(
        sess.predict(Xq), bst.predict(Xq, num_iteration=3),
        rtol=RTOL, atol=ATOL)
    port.restore(token)
    np.testing.assert_allclose(sess.predict(Xq), before, rtol=0, atol=0)


@pytest.mark.parametrize("boosting", ["rf", "dart"])
def test_rf_and_dart_models_serve(boosting, tmp_path):
    extra = {"boosting": boosting}
    if boosting == "rf":
        extra.update(bagging_fraction=0.7, bagging_freq=1)
    bst, port, Xq, _ = train_case("binary", tmp_path, rounds=4,
                                  n_query=600, extra=extra)
    assert port.inner.name == boosting
    np.testing.assert_allclose(port.predict(Xq), bst.predict(Xq),
                               rtol=RTOL, atol=ATOL)


def test_cuda_default_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(LightGBMError):
        lgt.Booster(model_str="tree\nversion=v3\nobjective=binary\n"
                              "end of trees\n")
