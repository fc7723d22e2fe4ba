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
an online trainer per served model behind ``POST /ingest``; with
``fleet_dir``, ``fleet_url`` or ``fleet_urls`` it joins a fleet as a
trainer (``fleet_role=trainer``: publishes its promotions, optionally
lease-gated) or a replica (``fleet_role=replica``: watches the store and
hot-swaps each published model). Settings the port cannot honour raise,
naming their ROADMAP item: span tracing, telemetry and trace dumps and
the run ledger (A13, item 10).
"""
from __future__ import annotations

import os
import signal
import socket
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
        /ingest/<id>``).

        Fleet mode (one model per store): ``fleet_dir`` is a shared
        directory, ``fleet_url`` a remote trainer's ``/fleet`` routes (a
        replica), ``fleet_urls`` several endpoints (a replica fails over
        among them; a trainer writes through the first, the store host).
        A trainer publishes its promotions and, with
        ``fleet_lease_ttl_s`` > 0, boots in standby and trains only while
        it holds the store's lease; a replica boots from the newest
        verified publish and hot-swaps every later one."""
        from .online.registry import ModelRegistry
        from .serve.http import PredictServer

        cfg = self.config
        entries = []
        if cfg.input_model:
            entries.append(("default", cfg.input_model))
        for spec in cfg.serve_models:
            mid, path = spec.split("=", 1)
            entries.append((mid.strip(), path.strip()))
        fleet_on = bool(cfg.fleet_dir or cfg.fleet_url or cfg.fleet_urls)
        if not entries and not fleet_on:
            Log.fatal("task=serve requires input_model or serve_models")
        fleet_trainer = fleet_on and cfg.fleet_role == "trainer"
        fleet_replica = fleet_on and cfg.fleet_role == "replica"
        holder = "%s:%d" % (socket.gethostname(), os.getpid())
        if fleet_trainer and not cfg.online_train:
            Log.fatal("fleet_role=trainer requires online_train=true (the "
                      "trainer is the process that publishes promotions)")
        if fleet_replica and cfg.online_train:
            Log.fatal("fleet_role=replica is serve-only (replicas apply "
                      "published models, they never train); drop "
                      "online_train or use fleet_role=trainer")
        if fleet_on and len(entries) > 1:
            Log.fatal("fleet mode serves one model per store; drop "
                      "serve_models or run one process per model")
        if fleet_replica and not entries:
            entries = [("default", "")]   # boot purely from the store
        tenant_weights = {}
        for spec in cfg.serve_tenant_weights:
            name, _, w = spec.partition("=")
            tenant_weights[name.strip()] = float(w)
        online = self._online_config()
        registry = ModelRegistry()
        watcher = store = None
        try:
            for mid, path in entries:
                booster, applied = None, 0
                if fleet_on:
                    store, booster, applied = self._fleet_store(
                        mid, fleet_trainer, fleet_replica)
                if booster is not None:
                    Log.info("fleet: %s booted from published v%d", mid,
                             applied)
                else:
                    if not path:
                        Log.fatal("fleet: store %s has no published model "
                                  "yet and no input_model to seed from",
                                  cfg.fleet_dir or cfg.fleet_url
                                  or ",".join(cfg.fleet_urls))
                    booster = self._booster(path)
                    if fleet_trainer and store.latest_publish() is None:
                        # seed the store so replicas can boot before the
                        # first promotion
                        store.publish(booster.model_to_string(),
                                      event="boot")
                model_online = None if online is None else dict(online)
                if fleet_trainer:
                    model_online.update(
                        store=store, replay=cfg.fleet_replay,
                        lease_ttl_s=cfg.fleet_lease_ttl_s,
                        holder_id=holder,
                        compact_bytes=cfg.fleet_compact_bytes,
                        keep_artifacts=cfg.fleet_keep_artifacts,
                        snapshot_rows=cfg.fleet_snapshot_rows,
                        heartbeat_interval_s=cfg.fleet_heartbeat_interval_s)
                entry = registry.register(
                    mid, booster,
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
                    online=model_online)
                if fleet_replica:
                    from .fleet import ReplicaWatcher
                    watcher = ReplicaWatcher(
                        entry.booster, store,
                        poll_interval_s=cfg.fleet_poll_interval_s,
                        applied_version=applied,
                        backoff_max_s=cfg.fleet_backoff_max_s,
                        heartbeat_interval_s=cfg.fleet_heartbeat_interval_s,
                        node_id=holder)
            server = PredictServer(registry=registry, host=cfg.serve_host,
                                   port=cfg.serve_port)
        except BaseException:
            if watcher is not None:
                watcher.close()
            registry.close()
            raise
        server.fleet_watcher = watcher
        if cfg.fleet_dir and store is not None:
            # a local store: the /fleet routes (remote replicas converge
            # through them) and the /healthz lease and log state
            server.fleet_store = store
        elif store is not None:
            # a remote store: its retries and backoff on /healthz
            server.fleet_transport = store
        host, port = server.address
        if fleet_trainer:
            # advertise this trainer's serving endpoint in the lease
            # record (acquire and renew write it): the leader hint that
            # ingest forwarding follows. The port is known only after
            # the bind, so the next lease touch carries it.
            adv_host = host if host not in ("0.0.0.0", "::") \
                else socket.gethostname()
            ent = registry.get()
            if ent.online is not None:
                ent.online.advertise_url = "http://%s:%d" % (adv_host, port)
        if cfg.fleet_forward_ingest and store is not None:
            # relay labeled traffic that reaches this node to the lease
            # holder (replicas and standbys have no trainer to buffer it)
            from .fleet import IngestForwarder
            server.ingest_forwarder = IngestForwarder(
                store=store if cfg.fleet_dir else None,
                urls=(cfg.fleet_urls or
                      ([cfg.fleet_url] if cfg.fleet_url else ())),
                timeout_s=cfg.fleet_timeout_s)
        Log.info("Serving %s on http://%s:%d (POST /predict%s; GET "
                 "/healthz, /models)%s",
                 ", ".join("%s=%s" % e for e in entries), host, port,
                 ", /ingest" if online is not None else "",
                 " [fleet %s @ %s]" % (cfg.fleet_role,
                                       cfg.fleet_dir or cfg.fleet_url
                                       or ",".join(cfg.fleet_urls))
                 if fleet_on else "")
        return server

    def _fleet_store(self, model_id: str, trainer: bool, replica: bool):
        """(store, booster, applied version) of one fleet node: the store
        over ``fleet_dir`` or the remote endpoints, and the booster of its
        newest verified publish (None, 0 when nothing is published yet)."""
        from . import fleet

        cfg = self.config
        params = dict(self.raw_params)
        if cfg.fleet_dir:
            # a replica over a shared directory is a pure reader: no
            # torn-tail repair or orphan reaping on a live trainer's files
            store = fleet.FleetStore(cfg.fleet_dir, model_id,
                                     read_only=replica)
            booster, applied = fleet.bootstrap_model(store, params)
            return store, booster, applied
        net = dict(timeout_s=cfg.fleet_timeout_s,
                   backoff_max_s=cfg.fleet_backoff_max_s)
        if trainer:
            # the full write surface (lease, fenced publish, appends,
            # compaction) over HTTP against the store host
            store = fleet.RemoteWriteStore(cfg.fleet_urls[0], **net)
        elif len(cfg.fleet_urls) > 1:
            # liveness-ranked failover among several endpoints
            store = fleet.MultiEndpointStore(cfg.fleet_urls, **net)
            store.probe()
        else:
            store = fleet.RemoteStore(cfg.fleet_url or cfg.fleet_urls[0],
                                      **net)
        try:
            booster, applied = fleet.bootstrap_model(store, params)
        except Exception as exc:
            # the remote trainer may not be up yet; the watcher keeps
            # retrying with backoff
            Log.warning("fleet: remote bootstrap failed (%s: %s); watching "
                        "%s for the first publish", type(exc).__name__,
                        exc, cfg.fleet_url or ",".join(cfg.fleet_urls))
            booster, applied = None, 0
        return store, booster, applied

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
