"""The port's command line (``lightgbm_tpu_torch.cli``, ``python -m
lightgbm_tpu_torch``) on the host: ``task=train`` from a CSV gives the
model of the in-memory ``train`` on the same rows byte for byte and the
JAX CLI's trees; ``task=predict`` (``predict_contrib`` too),
``task=convert_model`` and ``task=refit`` agree with the JAX CLI on one
model file; ``save_binary`` round-trips; the two-round loader, valid sets
and ``input_model`` train through it; ``task=serve online_train=true``
answers ``/ingest``; the fleet's settings build trainer and replica
nodes and their bad values raise the JAX CLI's errors; every setting the
port cannot honour raises, naming its ROADMAP item; and the module runs
as a subprocess, ``task=serve`` included, which drains on SIGTERM (with
online training too)."""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from torch_port_cases import (ATOL, CPU, REFIT_ATOL, REFIT_RTOL, REPO,
                              RTOL, assert_same_trees,
                              one_torch_thread, torch_threads)

import lightgbm_tpu as lgb
from lightgbm_tpu import cli as jax_cli

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """Every test here trains on the host: one torch thread (subprocesses
    get OMP_NUM_THREADS=1; torch_port_cases.one_torch_thread)."""


@pytest.fixture(autouse=True, scope="module")
def _one_thread_module():
    """The module-scoped training fixtures run before any function-scoped
    fixture: one torch thread for them too."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def _restore_log_level():
    """``cli.Application`` sets the process-global log level from
    ``verbosity``, as the reference's ResetLogLevel does: put the level
    and sink back after this module, so the tests that run after it in
    the same process log at the level they started with."""
    level, sink = log._default_level, log._default_sink
    yield
    log.Log.reset_log_level(level)
    log.Log.reset_callback(sink)


#: the training settings of every CLI run here (parity needs splits by
#: real gains, see torch_port_cases.train_params)
TRAIN = {"objective": "binary", "num_leaves": 15, "num_iterations": 5,
         "min_data_in_leaf": 20, "min_gain_to_split": 1e-3,
         "verbosity": -1}


def _args(d):
    return ["%s=%s" % kv for kv in d.items()]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """train.csv / valid.csv: label then 8 features at 1/1024 (exact in
    text), a few empty fields (NaN)."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    X = np.round(rng.randn(2600, 8) * 1024) / 1024
    y = (X[:, 0] - 0.7 * X[:, 1] + 0.3 * rng.randn(2600) > 0).astype(float)
    X[rng.rand(*X.shape) < 0.03] = np.nan
    out = {"dir": d, "X": X[:2000], "y": y[:2000],
           "Xv": X[2000:], "yv": y[2000:]}
    for name, sl in (("train", slice(0, 2000)), ("valid", slice(2000, None))):
        lines = []
        for yy, row in zip(y[sl], X[sl]):
            lines.append(",".join(["%.0f" % yy] + [
                "" if np.isnan(v) else "%.10f" % v for v in row]))
        path = d / ("%s.csv" % name)
        path.write_text("\n".join(lines) + "\n")
        out[name] = str(path)
    return out


@pytest.fixture(scope="module")
def port_model(files):
    """The port CLI's model file for TRAIN on train.csv."""
    model = files["dir"] / "port_model.txt"
    cli.main(_args(dict(TRAIN, task="train", data=files["train"],
                        output_model=str(model), **CPU)))
    return str(model)


def test_train_equals_in_memory_and_jax(files, port_model):
    text = open(port_model).read()
    params = dict(TRAIN, **CPU)
    mem = lgt.train(dict(params), lgt.Dataset(files["X"], label=files["y"],
                                              params=dict(params)))
    assert text == mem.model_to_string()
    jmodel = files["dir"] / "jax_model.txt"
    jax_cli.Application(jax_cli.parse_args(_args(dict(
        TRAIN, task="train", data=files["train"],
        output_model=str(jmodel))))).run()
    assert_same_trees(lgb.Booster(model_file=str(jmodel)).inner.models,
                      lgt.Booster(CPU, model_file=port_model).inner.models)


@pytest.mark.parametrize("extra", [
    {}, {"predict_raw_score": "true", "num_iteration_predict": 3},
    {"predict_leaf_index": "true"}])
def test_predict_equals_jax(files, port_model, extra):
    """One model file through both CLIs; the port's file is "%g" of its
    Booster.predict."""
    d = files["dir"]
    outs = {}
    for pkg, run in (("port", lambda a: cli.main(a + _args(CPU))),
                     ("jax", lambda a: jax_cli.Application(
                         jax_cli.parse_args(a)).run())):
        out = d / ("pred_%s.txt" % pkg)
        run(_args(dict(extra, task="predict", data=files["valid"],
                       input_model=port_model, output_result=str(out),
                       verbosity=-1)))
        outs[pkg] = np.loadtxt(out, ndmin=2)
    assert outs["port"].shape[0] == len(files["yv"])
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=RTOL,
                               atol=ATOL)
    bst = lgt.Booster(CPU, model_file=port_model)
    want = bst.predict(files["Xv"],
                       raw_score=bool(extra.get("predict_raw_score")),
                       num_iteration=extra.get("num_iteration_predict"),
                       pred_leaf=bool(extra.get("predict_leaf_index")))
    want = want.reshape(len(files["yv"]), -1)
    text = open(d / "pred_port.txt").read()
    assert text == "".join("\t".join("%g" % v for v in row) + "\n"
                           for row in want)


def test_save_binary_round_trip(files, port_model, tmp_path):
    """task=save_binary writes <data>.bin; data=<that file> trains the
    same model without re-binning."""
    data = tmp_path / "train.csv"
    data.write_text(open(files["train"]).read())
    cli.main(_args(dict(TRAIN, task="save_binary", data=str(data), **CPU)))
    binfile = str(data) + ".bin"
    assert cli.is_binary_dataset(binfile)
    assert not cli.is_binary_dataset(str(data))
    loaded = lgt.Dataset(binfile).construct()
    want = lgt.Dataset(files["X"], label=files["y"],
                       params=dict(TRAIN, **CPU)).construct()
    np.testing.assert_array_equal(loaded.binned, want.binned)
    model = tmp_path / "m.txt"
    cli.main(_args(dict(TRAIN, task="train", data=binfile,
                        output_model=str(model), **CPU)))
    assert open(model).read() == open(port_model).read()


def test_two_round_valid_sets_and_input_model(files, port_model, tmp_path):
    """two_round bins from a reservoir sample that holds every row here:
    the same model. Valid sets with the training metric take the
    per-iteration path: the same model. input_model continues it."""
    for extra in ({"two_round": "true"},
                  {"valid": files["valid"],
                   "is_provide_training_metric": "true",
                   "metric": "auc"}):
        model = tmp_path / "m.txt"
        cli.main(_args(dict(TRAIN, task="train", data=files["train"],
                            output_model=str(model), **extra, **CPU)))
        assert open(model).read() == open(port_model).read(), extra
    cont = tmp_path / "cont.txt"
    cli.main(_args(dict(TRAIN, task="train", data=files["train"],
                        input_model=port_model, num_iterations=2,
                        output_model=str(cont), **CPU)))
    params = dict(TRAIN, **CPU, num_iterations=2)
    mem = lgt.train(dict(params), lgt.Dataset(files["X"], label=files["y"],
                                              params=dict(params)),
                    init_model=port_model)
    assert open(cont).read() == mem.model_to_string()
    assert mem.num_trees() == 7


def test_parse_args_config_first_command_line_wins(tmp_path):
    conf = tmp_path / "t.conf"
    conf.write_text("task = train\nnum_leaves = 7\n# c\nobjective = binary\n")
    args = ["config=%s" % conf, "num_leaves=9", "--dump-trace", "t.json",
            "--dump-telemetry=x.json", "stray"]
    assert cli.parse_args(args) == jax_cli.parse_args(args) == {
        "task": "train", "num_leaves": "9", "objective": "binary",
        "dump_trace": "t.json", "dump_telemetry": "x.json"}


@pytest.mark.parametrize("args,item", [
    (["task=serve", "fleet_dir=store", "online_train=true",
      "input_model=m.txt"], "A12"),
    (["task=serve", "fleet_role=replica", "fleet_url=http://localhost:1",
      "input_model=m.txt", "fleet_timeout_s=1"], "A12"),
    (["task=train", "trace_spans=on"], "A13"),
    (["task=train", "--dump-telemetry", "t.json"], "A13"),
    (["task=train", "--dump-trace=t.json"], "A13"),
    (["task=serve", "obs_ledger=true"], "A13"),
])
def test_refused_settings_name_their_item(files, port_model, args, item,
                                          tmp_path):
    """The settings the port cannot honour raise, naming their ROADMAP
    item (A13, item 10). The fleet's (A12, item 8) raised until the fleet
    was ported: those cases now build their serving node, a trainer over
    ``fleet_dir`` and a replica over ``fleet_url`` (whose trainer is not
    up: it boots from ``input_model`` and keeps watching), and close
    it."""
    args = [a.replace("m.txt", port_model)
            .replace("fleet_dir=store", "fleet_dir=%s" % (tmp_path / "s"))
            for a in args]
    args += ["data=%s" % files["train"], "device_type=cpu", "verbosity=-1"]
    if item == "A12":
        server = cli.Application(cli.parse_args(
            args + ["serve_port=0", "serve_warmup=false"])).make_server()
        try:
            doc = server.healthz()
            if "fleet_dir=%s" % (tmp_path / "s") in args:
                assert doc["fleet_store"]["last_published_version"] == 1
                assert server.online.state()["role"] == "solo"
            else:
                assert doc["fleet"]["applied_version"] == 0
                assert server.fleet_transport is not None
        finally:
            server.close()
        return
    with pytest.raises(LightGBMError, match="ROADMAP .*%s" % item):
        cli.main(args)


@pytest.mark.parametrize("setting", [
    "fleet_lease_ttl_s=-1", "fleet_snapshot_rows=100",
    "fleet_role=replica", "fleet_role=observer",
    "fleet_url=http://localhost:1",
])
def test_fleet_settings_raise_as_the_jax_package(files, port_model,
                                                 tmp_path, setting):
    """A bad fleet setting raises the JAX CLI's error: a negative lease
    ttl, snapshots without compaction, a replica without a store, an
    unknown role, a trainer over ``fleet_url``."""
    args = ["task=serve", "input_model=%s" % port_model, "verbosity=-1",
            "online_train=true", setting]
    if "fleet_url" not in setting and setting != "fleet_role=replica":
        args.append("fleet_dir=%s" % (tmp_path / "s"))
    with pytest.raises(Exception) as want:
        jax_cli.Application(jax_cli.parse_args(args))
    with pytest.raises(LightGBMError) as got:
        cli.Application(cli.parse_args(args + ["device_type=cpu"]))
    assert str(got.value) == str(want.value)


def test_convert_model_writes_the_jax_cpp(files, port_model, tmp_path):
    """task=convert_model: the C++ source of the JAX CLI, byte for byte
    (and the JSON dump for convert_model_language=json)."""
    for lang in ("cpp", "json"):
        out = {}
        for pkg, run in (("port", lambda a: cli.main(a + _args(CPU))),
                         ("jax", lambda a: jax_cli.Application(
                             jax_cli.parse_args(a)).run())):
            path = tmp_path / ("%s.%s" % (pkg, lang))
            run(_args(dict(task="convert_model", input_model=port_model,
                           convert_model=str(path),
                           convert_model_language=lang, verbosity=-1)))
            out[pkg] = path.read_text()
        assert out["port"] == out["jax"] and len(out["port"]) > 1000, lang


def test_refit_writes_the_jax_refit(files, port_model, tmp_path):
    """task=refit on valid.csv: the refit model's leaves within refit's
    tolerance of the JAX CLI's (torch_port_cases.REFIT_RTOL / _ATOL)."""
    models = {}
    for pkg, run in (("port", lambda a: cli.main(a + _args(CPU))),
                     ("jax", lambda a: jax_cli.Application(
                         jax_cli.parse_args(a)).run())):
        path = tmp_path / ("refit_%s.txt" % pkg)
        run(_args(dict(task="refit", data=files["valid"],
                       input_model=port_model, output_model=str(path),
                       refit_decay_rate=0.7, verbosity=-1)))
        models[pkg] = lgt.Booster(CPU, model_file=str(path)).inner.models
    before = lgt.Booster(CPU, model_file=port_model).inner.models
    assert len(models["port"]) == len(before) == 5
    for a, b, c in zip(models["jax"], models["port"], before):
        np.testing.assert_array_equal(b.split_feature, c.split_feature)
        assert not np.array_equal(b.leaf_value, c.leaf_value)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value,
                                   rtol=REFIT_RTOL, atol=REFIT_ATOL)


def test_predict_contrib_writes_the_jax_numbers(files, port_model,
                                                tmp_path):
    outs = {}
    for pkg, run in (("port", lambda a: cli.main(a + _args(CPU))),
                     ("jax", lambda a: jax_cli.Application(
                         jax_cli.parse_args(a)).run())):
        out = tmp_path / ("contrib_%s.txt" % pkg)
        run(_args(dict(task="predict", data=files["valid"],
                       input_model=port_model, output_result=str(out),
                       predict_contrib="true", verbosity=-1)))
        outs[pkg] = out.read_text()
    assert outs["port"] == outs["jax"]
    got = np.loadtxt(tmp_path / "contrib_port.txt", ndmin=2)
    assert got.shape == (len(files["yv"]), 9)


def test_serve_online_train_answers_ingest(files, port_model):
    """task=serve online_train=true: /ingest feeds the model's trainer,
    whose worker refits and promotes; /healthz shows it."""
    app = cli.Application(cli.parse_args(_args(dict(
        task="serve", input_model=port_model, serve_port=0,
        serve_warmup="false", online_train="true",
        online_trigger_rows=256, online_min_rows=64,
        online_shadow_rows=512, verbosity=-1, **CPU))))
    server = app.make_server()
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = "http://%s:%d" % server.address

    def post(path, obj):
        req = urllib.request.Request(base + path,
                                     data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        X = np.nan_to_num(files["X"], nan=0.0)
        out = post("/ingest", {"rows": X[:300].tolist(),
                               "labels": files["y"][:300].tolist()})
        assert out == {"buffered_rows": 300, "rows": 300}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = json.loads(urllib.request.urlopen(
                base + "/healthz", timeout=60).read())
            st = st["models"]["default"]["online"]
            if st["trains"] >= 1 and st["last_result"] != "idle":
                break
            time.sleep(0.05)
        assert st["mode"] == "refit" and st["errors"] == 0, st
        assert st["promotions"] + st["rejections"] == 1, st
        assert len(post("/predict", {"rows": X[:4].tolist()})
                   ["predictions"]) == 4
    finally:
        server.shutdown()
        th.join(timeout=30)
        server.close()


def test_ranking_loads_groups_and_refuses_to_train(tmp_path):
    """(Named for the refusal it held until ranking trained.) A ranking
    file and its ``.query`` sidecar train lambdarank through the command
    line: the model byte-equal to ``train`` on the same arrays and
    groups."""
    rng = np.random.RandomState(2)
    path = tmp_path / "rank.tsv"
    table = np.column_stack([rng.randint(0, 3, 60), rng.randn(60, 3)])
    np.savetxt(path, table, delimiter="\t", fmt="%.5f")
    np.savetxt(str(path) + ".query", [20, 25, 15], fmt="%d")
    params = {"objective": "lambdarank", "num_leaves": 4,
              "min_data_in_leaf": 5, "num_iterations": 3, "verbosity": -1}
    model = tmp_path / "m.txt"
    cli.main(_args(dict(params, task="train", data=str(path),
                        output_model=str(model), **CPU)))
    table = np.loadtxt(path, delimiter="\t")
    ds = lgt.Dataset(table[:, 1:], label=table[:, 0], group=[20, 25, 15],
                     params=dict(params, **CPU))
    mem = lgt.train(dict(params, **CPU), ds)
    assert mem.num_trees() == 3
    assert open(model).read() == mem.model_to_string()


def _env():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_module_trains_from_a_config_file(files, port_model, tmp_path):
    conf = tmp_path / "train.conf"
    model = tmp_path / "m.txt"
    conf.write_text("".join("%s = %s\n" % kv for kv in dict(
        TRAIN, task="train", data=files["train"], output_model=str(model),
        **CPU).items()))
    out = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                          "config=%s" % conf], cwd=str(tmp_path),
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert open(model).read() == open(port_model).read()


def test_no_arguments_prints_the_usage(capsys):
    assert cli.main([]) == 0
    assert "python -m lightgbm_tpu_torch config=" in capsys.readouterr().out


def _serve_drains_on_sigterm(files, port_model, tmp_path, extra=()):
    """``python -m lightgbm_tpu_torch task=serve``: answer one /predict
    (and whatever ``extra``'s settings add, through the returned url's
    callback), then drain on SIGTERM and exit 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=serve",
         "input_model=%s" % port_model, "serve_port=0", "device_type=cpu",
         "serve_warmup=false", *extra], cwd=str(tmp_path), env=_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in
                                              proc.stderr], daemon=True)
    reader.start()

    def post(url, obj):
        req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        url = None
        while url is None:
            line = lines.get(timeout=120)
            if "Serving " in line:
                url = line.split(" on ", 1)[1].split()[0]
        rows = np.nan_to_num(files["Xv"][:5], nan=0.0)
        got = post(url + "/predict", {"rows": rows.tolist()})["predictions"]
        want = lgt.Booster(CPU, model_file=port_model).predict(rows)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        ingest = None
        if "online_train=true" in extra:
            ingest = post(url + "/ingest", {"rows": rows.tolist(),
                                            "labels": files["yv"][:5]
                                            .tolist()})
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get_nowait())
        assert any("drained and closed" in ln for ln in rest), rest
        return ingest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_module_serves_and_drains_on_sigterm(files, port_model, tmp_path):
    _serve_drains_on_sigterm(files, port_model, tmp_path)


def test_module_serves_online_and_drains_on_sigterm(files, port_model,
                                                    tmp_path):
    """The same with online_train=true: /ingest buffers the rows, and
    SIGTERM stops the trainer's worker with the server."""
    ingest = _serve_drains_on_sigterm(
        files, port_model, tmp_path,
        extra=("online_train=true", "online_trigger_rows=1000"))
    assert ingest == {"buffered_rows": 5, "rows": 5}


def test_chip_smoke_file_phase_on_cpu(monkeypatch):
    """chip_smoke's file phase at a tiny size on the host: both construct
    routes, the CSV files through the CLI and the subprocess, every model
    byte-equal to train's on the same arrays."""
    import torch
    import chip_smoke
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # for its subprocess
    monkeypatch.setattr(chip_smoke, "FILE_TRAIN_ROWS", 1500)
    monkeypatch.setattr(chip_smoke, "FILE_VALID_ROWS", 300)
    monkeypatch.setattr(chip_smoke, "FILE_TREES", 3)
    data = chip_smoke.training_data(0, 3000, 500)
    summary, counts = chip_smoke.phase_file(torch.device("cpu"), data, 15,
                                            "cpu")
    assert summary["construct"]["rows"] == 3500
    assert summary["predict_max_abs_err"] <= 1e-6
    assert len(summary["model_sha256"]) == 64
