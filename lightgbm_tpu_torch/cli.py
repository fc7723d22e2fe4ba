"""Command-line application: train / predict / convert_model / refit /
save_binary / serve (PyTorch port of ``lightgbm_tpu/cli.py``).

Equivalent of the reference CLI (reference: src/main.cpp:11,
src/application/application.h:29 Application, application.cpp:52
LoadParameters). Usage mirrors the reference:

    python -m lightgbm_tpu_torch config=train.conf [key=value ...]

Everything runs on the CUDA card unless ``device_type=cpu`` asks for the
host. Files parse and bin natively (``io.py``, ``io_native.py``). A
``data`` file that ``task=save_binary`` wrote (``<data>.bin``) loads
without re-parsing or re-binning. ``task=serve online_train=true`` runs
an online trainer per served model behind ``POST /ingest``. Settings the
port cannot honour raise, naming their ROADMAP item: every ``fleet_*``
setting (A12, queue A item 8), span tracing, telemetry and trace dumps
and the run ledger (A13, item 10).
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Any, Dict, List, Optional

from .basic import Booster, Dataset
from .config import Config, resolve_aliases
from .engine import train as _train
from .io import load_config_file, load_text_file
from .learner import _refuse
from .utils.log import Log, verbosity_to_level

#: the JAX CLI's flag-style extras, mapped to their parameters
_FLAGS = {"--dump-telemetry": "dump_telemetry", "--dump-trace": "dump_trace"}


def parse_args(argv: List[str]) -> Dict[str, Any]:
    """``config=file`` + ``key=value`` overrides (reference:
    application.cpp:52-85 — config file first, the command line wins).
    ``--dump-telemetry PATH`` and ``--dump-trace PATH`` map to their
    parameters, as in the JAX CLI (the port refuses both, ROADMAP A13)."""
    cli: Dict[str, str] = {}
    argv = list(argv)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _FLAGS and i + 1 < len(argv):
            cli[_FLAGS[a]] = argv[i + 1].strip()
            i += 2
            continue
        if "=" in a and a.split("=", 1)[0] in _FLAGS:
            cli[_FLAGS[a.split("=", 1)[0]]] = a.split("=", 1)[1].strip()
            i += 1
            continue
        if "=" not in a:
            Log.warning("Unknown argument: %s", a)
            i += 1
            continue
        k, v = a.split("=", 1)
        cli[k.strip()] = v.strip()
        i += 1
    params: Dict[str, Any] = {}
    if "config" in cli or "config_file" in cli:
        params.update(load_config_file(cli.get("config")
                                       or cli["config_file"]))
    params.update(cli)
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def is_binary_dataset(path: str) -> bool:
    """True for a file that ``save_binary`` wrote (an npz archive)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False


class Application:
    """(reference: application.h:29)"""

    def __init__(self, params: Dict[str, Any]) -> None:
        self.raw_params = resolve_aliases(params)
        self.config = Config.from_params(params)
        Log.reset_log_level(verbosity_to_level(self.config.verbosity))
        cfg = self.config
        if cfg.trace_spans != "off":
            _refuse("trace_spans=%s" % cfg.trace_spans, "A13, queue A item 10")
        for key in ("dump_telemetry", "dump_trace"):
            if getattr(cfg, key):
                _refuse("--%s" % key.replace("_", "-"),
                        "A13, queue A item 10")
        if cfg.obs_ledger or cfg.obs_hbm_sample_interval_s > 0 \
                or cfg.telemetry_dump_interval_s > 0:
            _refuse("obs_ledger, obs_hbm_sample_interval_s and "
                    "telemetry_dump_interval_s", "A13, queue A item 10")
        fleet = sorted(k for k in self.raw_params if k.startswith("fleet_"))
        if fleet:
            _refuse("the fleet settings (%s)" % ", ".join(fleet),
                    "A12, queue A item 8")

    def run(self) -> None:
        task = self.config.task
        if task == "train":
            self.train()
        elif task in ("predict", "prediction", "test"):
            self.predict()
        elif task == "save_binary":
            self.save_binary()
        elif task == "serve":
            self.serve()
        elif task == "convert_model":
            self.convert_model()
        elif task == "refit":
            self.refit()
        else:
            Log.fatal("Unknown task: %s", task)

    def _load_train_data(self) -> Dataset:
        cfg = self.config
        params = dict(self.raw_params)
        if is_binary_dataset(cfg.data):
            return Dataset(cfg.data, params=params)
        if cfg.two_round:
            from .io import load_dataset_two_round
            binned = load_dataset_two_round(cfg.data, cfg)
            if binned is not None:
                ds = Dataset(None, params=params)
                ds._constructed = binned
                return ds
        X, label, weight, group, names = load_text_file(cfg.data, cfg)
        return Dataset(X, label=label, weight=weight, group=group,
                       feature_name=names or "auto", params=params)

    def train(self) -> None:
        cfg = self.config
        train_set = self._load_train_data()
        valid_sets, valid_names = [], []
        for i, vf in enumerate(cfg.valid):
            Xv, lv, wv, gv, _ = load_text_file(vf, cfg)
            valid_sets.append(train_set.create_valid(Xv, label=lv, weight=wv,
                                                     group=gv))
            valid_names.append("valid_%d" % (i + 1) if len(cfg.valid) > 1
                               else "valid_1")
        params = dict(self.raw_params)
        params.setdefault("is_provide_training_metric",
                          cfg.is_provide_training_metric)
        if cfg.is_provide_training_metric:
            valid_sets.insert(0, train_set)
            valid_names.insert(0, "training")
        bst = _train(params, train_set, num_boost_round=cfg.num_iterations,
                     valid_sets=valid_sets, valid_names=valid_names,
                     init_model=cfg.input_model or None)
        bst.save_model(cfg.output_model)
        Log.info("Finished training; model saved to %s", cfg.output_model)

    def _booster(self, path: str) -> Booster:
        return Booster(dict(self.raw_params), model_file=path)

    def predict(self) -> None:
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("task=predict requires input_model")
        bst = self._booster(cfg.input_model)
        X, _, _, _, _ = load_text_file(cfg.data, cfg)
        pred = bst.predict(
            X, raw_score=cfg.predict_raw_score,
            start_iteration=cfg.start_iteration_predict,
            num_iteration=(cfg.num_iteration_predict
                           if cfg.num_iteration_predict > 0 else None),
            pred_leaf=cfg.predict_leaf_index,
            pred_contrib=cfg.predict_contrib)
        pred2d = pred if pred.ndim > 1 else pred.reshape(-1, 1)
        with open(cfg.output_result, "w") as f:
            for row in pred2d:
                f.write("\t".join("%g" % v for v in row) + "\n")
        Log.info("Finished prediction; results saved to %s",
                 cfg.output_result)

    def convert_model(self) -> None:
        """(reference: task=convert_model, gbdt_model_text.cpp
        ModelToIfElse for convert_model_language=cpp; the JSON dump
        otherwise)."""
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("task=convert_model requires input_model")
        bst = self._booster(cfg.input_model)
        out = cfg.convert_model or "gbdt_prediction.cpp"
        with open(out, "w") as f:
            if cfg.convert_model_language == "cpp":
                f.write(bst.inner.to_if_else_cpp())
            else:
                f.write(bst.inner.dump_json())
        Log.info("Model converted (%s) to %s", cfg.convert_model_language,
                 out)

    def refit(self) -> None:
        """Refit ``input_model``'s leaves on ``data`` and write the model
        to ``output_model`` (``Booster.refit``, on the booster's
        device)."""
        cfg = self.config
        if not cfg.input_model:
            Log.fatal("task=refit requires input_model")
        bst = self._booster(cfg.input_model)
        X, label, _, _, _ = load_text_file(cfg.data, cfg)
        new_bst = bst.refit(X, label, decay_rate=cfg.refit_decay_rate)
        new_bst.save_model(cfg.output_model)
        Log.info("Refit model saved to %s", cfg.output_model)

    def save_binary(self) -> None:
        """Write ``<data>.bin`` (the reference's name; an npz archive of
        the binned dataset that ``Dataset(path)`` and ``data=`` load)."""
        from .dataset import save_binned
        cfg = self.config
        path = cfg.data + ".bin"
        binned = self._load_train_data().construct()
        with open(path, "wb") as f:
            save_binned(binned, f)
        Log.info("Saved binary dataset to %s", path)

    def _online_config(self) -> Optional[Dict[str, Any]]:
        """The OnlineTrainer keyword arguments of ``online_train=true``,
        or None."""
        cfg = self.config
        if not cfg.online_train:
            return None
        return dict(
            mode=cfg.online_mode,
            trigger_rows=cfg.online_trigger_rows,
            trigger_interval_s=cfg.online_trigger_interval_s,
            buffer_rows=cfg.online_buffer_rows,
            shadow_rows=cfg.online_shadow_rows,
            promote_threshold=cfg.online_promote_threshold,
            min_rows=cfg.online_min_rows,
            continue_rounds=cfg.online_continue_rounds,
            decay_rate=cfg.refit_decay_rate,
            shadow_decay=cfg.online_shadow_decay,
            promote_patience=cfg.online_promote_patience,
            rollback_threshold=cfg.online_rollback_threshold,
            rollback_min_rows=cfg.online_rollback_min_rows)

    def make_server(self):
        """The PredictServer of ``task=serve``: ``input_model`` as
        "default" and every ``serve_models`` entry ``id=path``, each behind
        its own PredictSession and MicroBatcher (and, with
        ``online_train=true``, its own OnlineTrainer fed by ``POST
        /ingest/<id>``)."""
        from .online.registry import ModelRegistry
        from .serve.http import PredictServer

        cfg = self.config
        entries = []
        if cfg.input_model:
            entries.append(("default", cfg.input_model))
        for spec in cfg.serve_models:
            mid, path = spec.split("=", 1)
            entries.append((mid.strip(), path.strip()))
        if not entries:
            Log.fatal("task=serve requires input_model or serve_models")
        tenant_weights = {}
        for spec in cfg.serve_tenant_weights:
            name, _, w = spec.partition("=")
            tenant_weights[name.strip()] = float(w)
        online = self._online_config()
        registry = ModelRegistry()
        try:
            for mid, path in entries:
                registry.register(
                    mid, self._booster(path),
                    buckets=cfg.serve_buckets or None,
                    max_batch_rows=cfg.serve_max_batch_rows,
                    max_wait_ms=cfg.serve_max_wait_ms,
                    max_queue_rows=cfg.serve_max_queue_rows,
                    overload=cfg.serve_overload,
                    tenant_quota_rows=cfg.serve_tenant_quota_rows,
                    tenant_weights=tenant_weights or None,
                    raw_score=cfg.predict_raw_score,
                    warmup=cfg.serve_warmup,
                    dispatch_mode=cfg.serve_dispatch,
                    forest=(None if cfg.tpu_forest_kernel == "auto"
                            else cfg.tpu_forest_kernel),
                    online=None if online is None else dict(online))
            server = PredictServer(registry=registry, host=cfg.serve_host,
                                   port=cfg.serve_port)
        except BaseException:
            registry.close()
            raise
        host, port = server.address
        Log.info("Serving %s on http://%s:%d (POST /predict%s; GET "
                 "/healthz, /models)", ", ".join("%s=%s" % e
                                                 for e in entries), host,
                 port, ", /ingest" if online is not None else "")
        return server

    def serve(self) -> None:
        """task=serve: the stdlib-HTTP JSON prediction endpoint. SIGTERM
        drains: new requests get 503, queued work finishes, exit 0."""
        server = self.make_server()

        def _on_sigterm(signum, frame):
            # begin_shutdown calls httpd.shutdown(), which would deadlock
            # on the thread inside serve_forever (this one): hop to a
            # helper thread and let serve_forever return
            threading.Thread(target=server.begin_shutdown,
                             name="lgbt-serve-drain", daemon=True).start()

        try:
            old_term = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:        # not the main thread (embedded use)
            old_term = None
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            Log.info("serve: interrupted, shutting down")
        finally:
            # drains the batchers: requests admitted before the drain flag
            # flipped still get their answers
            server.close()
            if old_term is not None:
                signal.signal(signal.SIGTERM, old_term)
        Log.info("serve: drained and closed")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 0
    Application(parse_args(argv)).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
