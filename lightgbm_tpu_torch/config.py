"""Single-source-of-truth parameter registry (PyTorch port).

A whole copy of ``lightgbm_tpu/config.py`` so that parameter dicts and
model files round-trip between the two packages: every field, alias and
validation clause is the same. Two fields read differently here:
``device_type`` picks the torch device (``cpu``, or the CUDA card for any
other value) and ``tpu_forest_kernel`` gates the CUDA forest kernel
(``auto`` resolves to ``on`` for eligible models, see boosting.py).

Equivalent of the reference's ``struct Config`` + generated alias
table (reference: include/LightGBM/config.h:34, src/io/config_auto.cpp,
helpers/parameter_generator.py). One dataclass holds every typed parameter;
``ALIASES`` maps every accepted alias to its canonical name
(reference: config.h:1087 ParameterAlias::KeyAliasTransform); ``Config.set``
applies a params dict with alias resolution and type coercion
(reference: src/io/config.cpp:196 Config::Set).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .utils.log import Log

TaskType = str  # train | predict | convert_model | refit | save_binary | serve


def _parse_int_list(v: Any) -> List[int]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(x) for x in str(v).split(",") if x != ""]


def _parse_float_list(v: Any) -> List[float]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    return [float(x) for x in str(v).split(",") if x != ""]


def _parse_str_list(v: Any) -> List[str]:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [str(x) for x in v]
    return [s for s in str(v).split(",") if s != ""]


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "+"):
        return True
    if s in ("false", "0", "no", "n", "-"):
        return False
    raise ValueError("cannot parse bool from %r" % (v,))


@dataclass
class Config:
    # ---- core (reference: config.h "Core Parameters") ----
    task: TaskType = "train"
    objective: str = "regression"
    boosting: str = "gbdt"
    data_sample_strategy: str = "bagging"  # bagging | goss
    data: str = ""
    valid: List[str] = field(default_factory=list)
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    tree_learner: str = "serial"  # serial | feature | data | voting
    num_threads: int = 0
    device_type: str = "cuda"  # cpu | gpu | cuda | tpu — cpu runs on the host;
    #   every other value runs on the CUDA card (raises when there is none)
    seed: Optional[int] = None
    deterministic: bool = False

    # ---- learning control (reference: config.h "Learning Control Parameters") ----
    force_col_wise: bool = False
    force_row_wise: bool = False
    histogram_pool_size: float = -1.0
    max_depth: int = -1
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    extra_trees: bool = False
    extra_seed: int = 6
    early_stopping_round: int = 0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    top_rate: float = 0.2
    other_rate: float = 0.1
    min_data_per_group: int = 100
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    top_k: int = 20
    monotone_constraints: List[int] = field(default_factory=list)
    monotone_constraints_method: str = "basic"
    monotone_penalty: float = 0.0
    feature_contri: List[float] = field(default_factory=list)
    forcedsplits_filename: str = ""
    refit_decay_rate: float = 0.9
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_penalty_feature_lazy: List[float] = field(default_factory=list)
    cegb_penalty_feature_coupled: List[float] = field(default_factory=list)
    path_smooth: float = 0.0
    interaction_constraints: str = ""
    verbosity: int = 1
    input_model: str = ""
    output_model: str = "LightGBM_model.txt"
    convert_model: str = "gbdt_prediction.cpp"
    convert_model_language: str = "cpp"   # cpp | json
    saved_feature_importance_type: int = 0
    snapshot_freq: int = -1
    # write the obs.Telemetry snapshot (JSON) here after the CLI task
    # finishes; empty = no dump (also settable as --dump-telemetry PATH).
    # The CLI additionally dumps to this path on SIGUSR1, and — while
    # task=serve runs — every telemetry_dump_interval_s seconds, so a
    # hung server can still be inspected from outside.
    dump_telemetry: str = ""
    telemetry_dump_interval_s: float = 0.0   # 0 = no periodic serve dump

    # ---- span tracing (obs_trace: host-side flight recorder) ----
    # off = no spans (zero-cost); on = train phases + serve chain;
    # serve_only = just the http/batcher/session request chain
    trace_spans: str = "off"
    trace_buffer_events: int = 65536  # flight recorder ring capacity
    # write the Chrome trace-event JSON (Perfetto-loadable) here after
    # the CLI task finishes; empty = no dump (also --dump-trace PATH,
    # and on SIGUSR2 while the task runs)
    dump_trace: str = ""

    # ---- device-cost observability (obs_device / obs_ledger) ----
    # capture Compiled.cost_analysis()/memory_analysis() per tracked-jit
    # compile into the telemetry device_cost section. Costs one extra AOT
    # backend compile per (entry point, signature) AT COMPILE TIME only;
    # steady-state training/serving pays nothing (the compile-budget
    # tests pin 0 new compiles on warm runs either way).
    obs_device_cost: bool = True
    # training health watchdog: per-block device-side isfinite reduction
    # over grads/scores. off (default) builds zero device ops; warn logs
    # and counts obs/nonfinite_*; raise aborts training on the block the
    # blow-up happened.
    obs_check_finite: str = "off"   # off | warn | raise
    # while task=serve runs, sample device.memory_stats() into the
    # hbm/* gauges every this many seconds (0 = boundary samples only;
    # CPU backends without memory stats degrade to a counted no-op)
    obs_hbm_sample_interval_s: float = 0.0
    # append one JSONL record per train/serve run (config fingerprint,
    # machine identity, resolved auto knobs, telemetry + device-cost
    # snapshot) and pre-resolve tpu_* auto knobs from the latest matching
    # (machine, dataset-shape, config) entry on the next run
    obs_ledger: bool = False
    obs_ledger_path: str = "lgbtpu_ledger.jsonl"

    # ---- linear tree ----
    linear_tree: bool = False
    linear_lambda: float = 0.0
    # leaf fit path: auto (device when a TPU backend is up, host otherwise)
    # | off (host NumPy oracle) | on (batched device solve, any backend)
    linear_device: str = "auto"

    # ---- dataset (reference: config.h "IO Parameters / Dataset") ----
    max_bin: int = 255
    max_bin_by_feature: List[int] = field(default_factory=list)
    min_data_in_bin: int = 3
    bin_construct_sample_cnt: int = 200000
    data_random_seed: int = 1
    is_enable_sparse: bool = True
    enable_bundle: bool = True
    use_missing: bool = True
    zero_as_missing: bool = False
    feature_pre_filter: bool = True
    pre_partition: bool = False
    two_round: bool = False
    header: bool = False
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    categorical_feature: Union[str, List[int]] = ""
    forcedbins_filename: str = ""
    save_binary: bool = False

    # ---- predict ----
    start_iteration_predict: int = 0
    num_iteration_predict: int = -1
    predict_raw_score: bool = False
    predict_leaf_index: bool = False
    predict_contrib: bool = False
    predict_disable_shape_check: bool = False
    pred_early_stop: bool = False
    pred_early_stop_freq: int = 10
    pred_early_stop_margin: float = 10.0
    output_result: str = "LightGBM_predict_result.txt"

    # ---- serving (task=serve: lightgbm_tpu/serve/ HTTP endpoint) ----
    serve_host: str = "127.0.0.1"
    serve_port: int = 8080            # 0 = bind an ephemeral port
    serve_max_batch_rows: int = 8192  # MicroBatcher coalescing cap (rows)
    serve_max_wait_ms: float = 2.0    # MicroBatcher first-request deadline
    serve_buckets: List[int] = field(default_factory=list)  # [] = default
    #   shape-bucket ladder (serve.session.DEFAULT_BUCKETS)
    serve_warmup: bool = True         # pre-compile the ladder on startup
    # admission control (serve.batcher.MicroBatcher backpressure):
    serve_max_queue_rows: int = 0     # cap on queued-but-undispatched rows
    #   (0 = unbounded). Overflow behavior is serve_overload.
    serve_overload: str = "shed"      # shed (reject at submit -> HTTP 429)
    #   | block (submitters wait for queue space; drains preserve order)
    serve_models: List[str] = field(default_factory=list)  # multi-tenant:
    #   extra "model_id=path" entries served next to input_model ("default")
    # per-tenant fairness (serve.batcher weighted-fair dequeue):
    serve_tenant_quota_rows: int = 0  # cap on any ONE tenant's queued rows
    #   (0 = no per-tenant cap; over-quota requests shed/block per
    #   serve_overload while other tenants keep being admitted)
    serve_tenant_weights: List[str] = field(default_factory=list)
    #   "tenant=weight" fair-share weights (unlisted tenants weigh 1.0)
    serve_dispatch: str = "continuous"  # continuous (standing dispatch loop,
    #   new requests join the next in-flight tile) | coalesce (wait up to
    #   serve_max_wait_ms for company, then launch — the older coalescing loop)

    # ---- online training (task=serve + online_train: lightgbm_tpu/online/) ----
    online_train: bool = False        # run an OnlineTrainer per served model
    online_mode: str = "refit"        # refit (frozen structure, leaf values
    #   re-estimated from ingested labels) | continue (init_model training)
    online_trigger_rows: int = 2048   # retrain once this many rows buffered
    online_trigger_interval_s: float = 0.0  # also retrain every N s (0 = off)
    online_buffer_rows: int = 65536   # bounded ingest buffer (drop-oldest)
    online_shadow_rows: int = 4096    # sliding window of recent labeled
    #   traffic the candidate is shadow-scored against before promotion
    online_promote_threshold: float = 1.0  # promote iff candidate_loss <=
    #   threshold * current_loss on the shadow window (1.0 = "not worse")
    online_min_rows: int = 64         # never train on fewer buffered rows
    online_continue_rounds: int = 10  # boosting rounds per continue-mode run
    online_shadow_decay: float = 1.0  # per-row exponential decay toward the
    #   oldest shadow row when scoring (1.0 = uniform window, current
    #   behavior; 0<d<1 weights recent traffic more)
    online_promote_patience: int = 1  # promotion hysteresis: candidate must
    #   win this many CONSECUTIVE shadow evaluations before the swap
    online_rollback_threshold: float = 0.0  # post-promotion live watch:
    #   auto-rollback when promoted live loss > threshold * displaced
    #   model's on traffic ingested AFTER the swap (0 = watch off)
    online_rollback_min_rows: int = 64  # fresh labeled rows required
    #   before the live watch renders its verdict

    # ---- fleet (task=serve --fleet: lightgbm_tpu/fleet/) ----
    fleet_dir: str = ""               # durable store root ("" = fleet off):
    #   <fleet_dir>/<model_id>/{events.jsonl, models/v*.txt}
    fleet_role: str = "trainer"       # trainer (ingest + train + publish)
    #   | replica (serve-only, watch the store and hot-swap publishes)
    fleet_poll_interval_s: float = 0.5  # replica publish-poll cadence
    fleet_replay: bool = True         # replay the event log on trainer boot
    #   (rows past the consumed watermark re-enter the training buffer,
    #   older rows only the shadow window)
    fleet_lease_ttl_s: float = 0.0    # trainer failover lease ttl (0 = one
    #   immortal trainer). >0: boot in standby, train only while holding
    #   the store lease; heartbeat every ttl/3; epoch-fenced publishes
    fleet_compact_bytes: int = 0      # compact events.jsonl once it exceeds
    #   this size (0 = never): snapshot watermark/streak + truncate the
    #   replayed prefix, replay stays bit-identical
    fleet_keep_artifacts: int = 0     # retention at compaction: keep only
    #   this many newest publish artifacts (0 = keep all)
    fleet_url: str = ""               # replica only: poll a remote trainer's
    #   /fleet endpoints instead of a shared-filesystem fleet_dir
    fleet_timeout_s: float = 5.0      # remote transport per-request timeout
    fleet_backoff_max_s: float = 10.0  # cap for replica poll backoff and
    #   remote transport retry backoff
    fleet_heartbeat_interval_s: float = 0.0  # federation cadence: every
    #   node (trainer/standby/replica) records a compact heartbeat to the
    #   store (remote replicas POST /fleet/heartbeat) for the
    #   /fleet/status + fleetctl rollup. 0 = heartbeats off
    fleet_urls: List[str] = field(default_factory=list)  # control plane:
    #   MULTIPLE fleet endpoints. replica: liveness-ranked failover
    #   (capped cooldown, switch on failure, exactly one version bump
    #   per publish regardless of endpoint); trainer: the first url is
    #   the store host the remote write surface (lease/publish/ingest/
    #   compact over HTTP) talks to — no shared filesystem needed
    fleet_forward_ingest: bool = False  # relay labeled traffic hitting
    #   this node (no online trainer here) to the current lease
    #   holder's advertised endpoint: leader_hint redirects, bounded
    #   X-Fleet-Hops chain, 503 when no leader is known
    fleet_snapshot_rows: int = 0      # compaction snapshot mode (0 = off):
    #   write at least this many retained ingest rows into one versioned
    #   snapshot blob instead of log lines, so a cold standby bootstraps
    #   from snapshot + tail instead of a full replay

    # ---- objective (reference: config.h "Objective Parameters") ----
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    boost_from_average: bool = True
    reg_sqrt: bool = False
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: List[float] = field(default_factory=list)
    objective_seed: int = 5

    # ---- metric ----
    metric: List[str] = field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 5])
    multi_error_top_k: int = 1
    auc_mu_weights: List[float] = field(default_factory=list)

    # ---- network (reference: config.h "Network Parameters"; here: jax.distributed) ----
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""
    machines: str = ""

    # ---- device ----
    gpu_platform_id: int = -1
    gpu_device_id: int = -1
    gpu_use_dp: bool = False
    num_gpu: int = 1
    # TPU-specific knobs (no reference analog):
    tpu_rows_per_chunk: int = 65536  # rows per device histogram chunk
    tpu_iter_block: int = 10         # boosting iterations fused per device launch
    tree_builder: str = "auto"       # auto|partition|dense: partitioned
    #   leaf-contiguous builder (O(child) histograms) vs round-1 dense
    #   (O(N) masked histograms; required when max_bin > 256)
    tpu_part_chunk: int = 0          # rows per partition compaction chunk
    #   (0 = auto: 1024 for the fused pallas kernel, 2048 for the XLA path)
    tpu_partition_kernel: str = "auto"  # auto|pallas|xla: fused Pallas DMA
    #   partition kernel (TPU only) vs the portable XLA op pipeline
    tpu_hist_chunk: int = 0          # rows per segment-histogram chunk
    #   (0 = auto: 4096 for narrow matrices, 1024 for wide ones)
    tpu_hist_kernel: str = "auto"    # auto|pallas|xla: in-VMEM Pallas
    #   segment-histogram kernel (TPU, F <= 64) vs the XLA einsum loop
    tpu_hist_lo: int = 0             # hi/lo split width of the histogram
    #   einsum factorization (0 = auto: 4 for narrow matrices, 8 for wide;
    #   all widths are bit-identical — this is a pure layout knob)
    tpu_hist_scatter: bool = True    # data-parallel: reduce-scatter
    #   histograms by feature-group block + owned-feature search + split
    #   argmax-sync (vs full psum + replicated search)
    tpu_hist_precision: str = "hilo"  # hilo (~2^-17 rel, bf16 pair) |
    #   bf16 (single bf16 grads) | int8 (quantized training)
    tpu_work_layout: str = "auto"    # auto|rows|planes: training work
    #   buffer layout. rows = (2, Npad, W) row-major; planes = transposed
    #   (2, W, Npad) feature-major planes — each 128-lane tile carries 128
    #   rows of ONE byte column (no dead lanes) and the root histogram is
    #   folded into the pack pass. auto: planes on TPU at row widths
    #   <= 256 B, rows elsewhere. Both layouts grow bit-identical trees.
    tpu_resident_state: str = "auto"  # auto|off|on: resident permuted
    #   training state (planes layout only). The bin planes live ONCE in a
    #   (F, Npad) resident buffer in original row order; the per-split
    #   partition moves only a slim 17-plane payload (route byte, i32
    #   row-index byte planes, g/h/c bytes) and segment histograms gather
    #   the bin planes through the permuted row-index plane. Cuts partition
    #   HBM traffic ~(F+12)/17-fold (~2.4x at F=28, ~8.8x at F=137) and
    #   grows bit-identical trees. auto: on when the resolved layout is
    #   planes on a TPU backend; on: force (requires a planes-capable
    #   config — errors with tpu_work_layout=rows or int8 histograms).
    tpu_split_kernel: str = "auto"   # auto|off|on: one-kernel split — ONE
    #   pallas_call per split running partition + smaller-child histogram
    #   + split scan as sequential phases (planes/resident layouts only),
    #   vs the three-launch chain. Bit-identical trees; the three-launch
    #   path stays as the parity oracle. auto: off everywhere until the
    #   fused kernel is validated on real Mosaic (scripts/split_bisect.py);
    #   on: force where structurally eligible (serial training, planes
    #   family, no feature bundling / CEGB / intermediate monotone).
    tpu_forest_kernel: str = "auto"  # auto|off|on: forest-at-once serving —
    #   one CUDA launch per dispatch walks the whole ensemble over
    #   BIN-space split-major node tables (ops/forest.py), vs the plain
    #   raw-threshold predict (ops/predict.py). auto: on wherever the model
    #   is eligible (a constructed train_set supplies bin mappers, node
    #   tables within FOREST_VMEM_BUDGET); off: always the plain predict.
    tpu_goss_compact: str = "auto"   # auto|off|on: GOSS row compaction —
    #   after the sampler emits the inbag mask, a device sort-by-inbag +
    #   static-shape slice packs the surviving rows into a compact work
    #   set sized ceil((top_rate+other_rate)*N) (+ a 4-sigma binomial
    #   margin), so planes pack / partition / histograms / split scan all
    #   run over the sample instead of N. The dense-mask path stays
    #   verbatim as the bit-parity oracle (and as the in-graph fallback
    #   for GOSS warmup iterations and margin overflow). auto: off
    #   everywhere until scripts/goss_bisect.py validates the win on
    #   hardware; on: force where eligible (GOSS sampling active, serial
    #   training, not int8 — the stochastic-rounding draws are
    #   row-position seeded).
    tpu_hist_mxu: str = "auto"       # auto|off|on: one-hot MXU histogram —
    #   a Pallas kernel (rows layout) that builds per-chunk one-hots in
    #   VMEM and feeds the MXU via matmul, serving both the f32 hi/lo-16
    #   path and the use_quantized_grad int8 path (int8 x int8 -> i32
    #   accumulation) from one kernel body. The segment-histogram einsum
    #   stays verbatim as the bit-parity oracle. auto: off everywhere
    #   until scripts/hist_mxu_bisect.py validates the MXU lowering on
    #   hardware; on: force where eligible (rows layout, pallas
    #   partition widths, hist chunk % 32 == 0).
    use_quantized_grad: bool = False  # int8 stochastic gradient quantization
    #   (LightGBM 4.x quantized training analog; rows per leaf <= ~16M)


    def __post_init__(self) -> None:
        # direct-constructor path must validate/normalize too (goss -> gbdt+goss)
        self._check()

    def set(self, params: Dict[str, Any]) -> "Config":
        """Apply a params dict (with aliases) onto this config in place.

        Mirrors reference Config::Set (src/io/config.cpp:196): alias
        resolution first, then typed assignment; unknown keys warn.
        """
        resolved = resolve_aliases(params)
        fields = {f.name: f for f in dataclasses.fields(self)}
        for key, value in resolved.items():
            if key not in fields:
                Log.warning("Unknown parameter: %s", key)
                continue
            f = fields[key]
            try:
                setattr(self, key, _coerce(f, value))
            except (TypeError, ValueError) as exc:
                Log.fatal('Parameter %s cannot be set to %r: %s', key, value, exc)
        self._check()
        return self

    def _check(self) -> None:
        """Constraint checks (reference: src/io/config.cpp Config::CheckParamConflict)."""
        if self.num_leaves < 2:
            Log.fatal("num_leaves must be >= 2, got %d", self.num_leaves)
        if self.max_bin < 2:
            Log.fatal("max_bin must be >= 2, got %d", self.max_bin)
        if not 0.0 < self.bagging_fraction <= 1.0:
            Log.fatal("bagging_fraction must be in (0, 1]")
        if not 0.0 < self.feature_fraction <= 1.0:
            Log.fatal("feature_fraction must be in (0, 1]")
        if self.boosting == "goss":
            # reference treats boosting=goss as gbdt + goss sampling
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.boosting == "rf":
            if self.bagging_freq <= 0 or self.bagging_fraction >= 1.0 or self.bagging_fraction <= 0.0:
                Log.fatal("RF mode requires 0 < bagging_fraction < 1 and bagging_freq > 0")
        if self.data_sample_strategy == "goss" and self.top_rate + self.other_rate > 1.0:
            Log.fatal("GOSS requires top_rate + other_rate <= 1.0")
        if self.objective in ("multiclass", "multiclassova", "softmax", "ova") and self.num_class <= 1:
            Log.fatal("num_class must be > 1 for multiclass objectives")
        if self.tpu_rows_per_chunk < 1:
            Log.fatal("tpu_rows_per_chunk must be >= 1, got %d",
                      self.tpu_rows_per_chunk)
        if self.tpu_iter_block < 1:
            Log.fatal("tpu_iter_block must be >= 1, got %d",
                      self.tpu_iter_block)
        if self.tpu_part_chunk < 0:
            Log.fatal("tpu_part_chunk must be >= 0 (0 = auto), got %d",
                      self.tpu_part_chunk)
        if self.tpu_partition_kernel not in ("auto", "pallas", "xla"):
            Log.fatal("tpu_partition_kernel must be auto, pallas or xla; "
                      "got %s", self.tpu_partition_kernel)
        if self.tpu_hist_chunk < 0:
            Log.fatal("tpu_hist_chunk must be >= 0 (0 = auto), got %d",
                      self.tpu_hist_chunk)
        if self.tpu_hist_precision not in ("hilo", "bf16", "int8"):
            Log.fatal("tpu_hist_precision must be hilo, bf16 or int8; "
                      "got %s", self.tpu_hist_precision)
        if self.tpu_hist_lo not in (0, 2, 4, 8, 16):
            Log.fatal("tpu_hist_lo must be one of 0 (auto), 2, 4, 8, 16; "
                      "got %d", self.tpu_hist_lo)
        if self.tpu_hist_kernel not in ("auto", "pallas", "xla"):
            Log.fatal("tpu_hist_kernel must be auto, pallas or xla; got %s",
                      self.tpu_hist_kernel)
        if self.tpu_work_layout not in ("auto", "rows", "planes"):
            Log.fatal("tpu_work_layout must be auto, rows or planes; got %s",
                      self.tpu_work_layout)
        if self.tpu_resident_state not in ("auto", "off", "on"):
            Log.fatal("tpu_resident_state must be auto, off or on; got %s",
                      self.tpu_resident_state)
        if self.tpu_split_kernel not in ("auto", "off", "on"):
            Log.fatal("tpu_split_kernel must be auto, off or on; got %s",
                      self.tpu_split_kernel)
        if self.tpu_forest_kernel not in ("auto", "off", "on"):
            Log.fatal("tpu_forest_kernel must be auto, off or on; got %s",
                      self.tpu_forest_kernel)
        if self.tpu_goss_compact not in ("auto", "off", "on"):
            Log.fatal("tpu_goss_compact must be auto, off or on; got %s",
                      self.tpu_goss_compact)
        if self.tpu_hist_mxu not in ("auto", "off", "on"):
            Log.fatal("tpu_hist_mxu must be auto, off or on; got %s",
                      self.tpu_hist_mxu)
        if self.serve_dispatch not in ("continuous", "coalesce"):
            Log.fatal("serve_dispatch must be continuous or coalesce; "
                      "got %s", self.serve_dispatch)
        if not 0 <= self.serve_port <= 65535:
            Log.fatal("serve_port must be in [0, 65535], got %d",
                      self.serve_port)
        if self.serve_max_batch_rows < 1:
            Log.fatal("serve_max_batch_rows must be >= 1, got %d",
                      self.serve_max_batch_rows)
        if self.serve_max_wait_ms < 0:
            Log.fatal("serve_max_wait_ms must be >= 0, got %g",
                      self.serve_max_wait_ms)
        if any(b < 1 for b in self.serve_buckets):
            Log.fatal("serve_buckets must be positive row counts")
        if self.serve_max_queue_rows < 0:
            Log.fatal("serve_max_queue_rows must be >= 0 (0 = unbounded), "
                      "got %d", self.serve_max_queue_rows)
        if self.serve_overload not in ("shed", "block"):
            Log.fatal("serve_overload must be shed or block; got %s",
                      self.serve_overload)
        for spec in self.serve_models:
            if "=" not in spec or not spec.split("=", 1)[0].strip() \
                    or not spec.split("=", 1)[1].strip():
                Log.fatal("serve_models entries must be model_id=path, "
                          "got %r", spec)
        if self.online_mode not in ("refit", "continue"):
            Log.fatal("online_mode must be refit or continue; got %s",
                      self.online_mode)
        if self.online_trigger_rows < 1:
            Log.fatal("online_trigger_rows must be >= 1, got %d",
                      self.online_trigger_rows)
        if self.online_trigger_interval_s < 0:
            Log.fatal("online_trigger_interval_s must be >= 0, got %g",
                      self.online_trigger_interval_s)
        if self.online_buffer_rows < 1:
            Log.fatal("online_buffer_rows must be >= 1, got %d",
                      self.online_buffer_rows)
        if self.online_shadow_rows < 1:
            Log.fatal("online_shadow_rows must be >= 1, got %d",
                      self.online_shadow_rows)
        if self.online_promote_threshold < 0:
            Log.fatal("online_promote_threshold must be >= 0, got %g",
                      self.online_promote_threshold)
        if self.online_min_rows < 1:
            Log.fatal("online_min_rows must be >= 1, got %d",
                      self.online_min_rows)
        if self.online_continue_rounds < 1:
            Log.fatal("online_continue_rounds must be >= 1, got %d",
                      self.online_continue_rounds)
        if not 0.0 < self.online_shadow_decay <= 1.0:
            Log.fatal("online_shadow_decay must be in (0, 1], got %g",
                      self.online_shadow_decay)
        if self.online_promote_patience < 1:
            Log.fatal("online_promote_patience must be >= 1, got %d",
                      self.online_promote_patience)
        if self.online_rollback_threshold < 0:
            Log.fatal("online_rollback_threshold must be >= 0 (0 = live "
                      "watch off), got %g", self.online_rollback_threshold)
        if self.online_rollback_min_rows < 1:
            Log.fatal("online_rollback_min_rows must be >= 1, got %d",
                      self.online_rollback_min_rows)
        if self.serve_tenant_quota_rows < 0:
            Log.fatal("serve_tenant_quota_rows must be >= 0 (0 = no "
                      "per-tenant cap), got %d", self.serve_tenant_quota_rows)
        for spec in self.serve_tenant_weights:
            name, _, w = spec.partition("=")
            try:
                ok = bool(name.strip()) and float(w) > 0
            except ValueError:
                ok = False
            if not ok:
                Log.fatal("serve_tenant_weights entries must be "
                          "tenant=positive_weight, got %r", spec)
        if self.fleet_role not in ("trainer", "replica"):
            Log.fatal("fleet_role must be trainer or replica; got %s",
                      self.fleet_role)
        if self.fleet_poll_interval_s <= 0:
            Log.fatal("fleet_poll_interval_s must be > 0, got %g",
                      self.fleet_poll_interval_s)
        if self.fleet_dir == "" and self.fleet_url == "" \
                and not self.fleet_urls and self.fleet_role == "replica":
            Log.fatal("fleet_role=replica requires a fleet_dir (shared "
                      "filesystem), fleet_url or fleet_urls (remote "
                      "endpoints) to watch")
        if self.fleet_dir != "" and (self.fleet_url != ""
                                     or self.fleet_urls):
            Log.fatal("fleet_dir and fleet_url(s) are mutually exclusive "
                      "(one store per node)")
        if self.fleet_url != "" and self.fleet_urls:
            Log.fatal("pass fleet_url or fleet_urls, not both")
        if self.fleet_url != "" and self.fleet_role != "replica":
            Log.fatal("fleet_url is replica-only; a remote TRAINER "
                      "needs fleet_urls (the control-plane write "
                      "surface)")
        if self.fleet_urls and self.fleet_role == "trainer" \
                and len(self.fleet_urls) != 1:
            Log.fatal("fleet_role=trainer takes exactly one fleet url "
                      "(the store host), got %d", len(self.fleet_urls))
        if len(set(u.rstrip("/") for u in self.fleet_urls)) \
                != len(self.fleet_urls):
            Log.fatal("fleet_urls contains duplicates: %s",
                      ",".join(self.fleet_urls))
        if self.fleet_forward_ingest and self.fleet_dir == "" \
                and not self.fleet_urls and self.fleet_url == "":
            Log.fatal("fleet_forward_ingest needs a fleet store "
                      "(fleet_dir) or fleet url(s) to resolve the "
                      "lease holder from")
        if self.fleet_snapshot_rows < 0:
            Log.fatal("fleet_snapshot_rows must be >= 0 (0 disables "
                      "snapshot compaction), got %d",
                      self.fleet_snapshot_rows)
        if self.fleet_snapshot_rows > 0 and self.fleet_compact_bytes == 0:
            Log.fatal("fleet_snapshot_rows needs fleet_compact_bytes > 0 "
                      "(snapshots are written at compaction time)")
        if self.fleet_lease_ttl_s < 0:
            Log.fatal("fleet_lease_ttl_s must be >= 0, got %g",
                      self.fleet_lease_ttl_s)
        if self.fleet_compact_bytes < 0 or self.fleet_keep_artifacts < 0:
            Log.fatal("fleet_compact_bytes/fleet_keep_artifacts must be "
                      ">= 0")
        if self.fleet_timeout_s <= 0:
            Log.fatal("fleet_timeout_s must be > 0, got %g",
                      self.fleet_timeout_s)
        if self.fleet_heartbeat_interval_s < 0:
            Log.fatal("fleet_heartbeat_interval_s must be >= 0 "
                      "(0 disables heartbeats), got %g",
                      self.fleet_heartbeat_interval_s)
        if self.fleet_backoff_max_s < self.fleet_poll_interval_s:
            Log.fatal("fleet_backoff_max_s must be >= "
                      "fleet_poll_interval_s, got %g < %g",
                      self.fleet_backoff_max_s, self.fleet_poll_interval_s)
        if self.linear_device not in ("auto", "off", "on"):
            Log.fatal("linear_device must be auto, off or on; got %s",
                      self.linear_device)
        if self.trace_spans not in ("off", "on", "serve_only"):
            Log.fatal("trace_spans must be off, on or serve_only; got %s",
                      self.trace_spans)
        if self.trace_buffer_events < 1:
            Log.fatal("trace_buffer_events must be >= 1, got %d",
                      self.trace_buffer_events)
        if self.telemetry_dump_interval_s < 0:
            Log.fatal("telemetry_dump_interval_s must be >= 0, got %g",
                      self.telemetry_dump_interval_s)
        if self.obs_check_finite not in ("off", "warn", "raise"):
            Log.fatal("obs_check_finite must be off, warn or raise; got %s",
                      self.obs_check_finite)
        if self.obs_hbm_sample_interval_s < 0:
            Log.fatal("obs_hbm_sample_interval_s must be >= 0, got %g",
                      self.obs_hbm_sample_interval_s)
        if self.obs_ledger and not self.obs_ledger_path:
            Log.fatal("obs_ledger=true requires a non-empty obs_ledger_path")
        warned = getattr(self, "_noop_warned", None)
        if warned is None:
            warned = set()
            object.__setattr__(self, "_noop_warned", warned)
        for name, (default, reason) in NOOP_PARAMS.items():
            if name in warned:
                continue
            if getattr(self, name) != default:
                warned.add(name)
                Log.warning("%s is accepted but has no effect here: %s",
                            name, reason)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_params(cls, params: Optional[Dict[str, Any]]) -> "Config":
        cfg = cls()
        if params:
            cfg.set(params)
        return cfg

    def clone(self) -> "Config":
        return dataclasses.replace(self)


def _coerce(f: dataclasses.Field, value: Any) -> Any:
    t = str(f.type)
    if t == "int":
        return int(value)
    if t == "float":
        return float(value)
    if t == "bool":
        return _parse_bool(value)
    if t in ("str", "TaskType"):
        return str(value)
    if t == "Optional[int]":
        return None if value is None or value == "" else int(value)
    if t == "List[int]":
        return _parse_int_list(value)
    if t == "List[float]":
        return _parse_float_list(value)
    if t == "List[str]":
        return _parse_str_list(value)
    return value


# Alias -> canonical map. Mirrors the generated table in the reference
# (src/io/config_auto.cpp:6-180 "parameter2aliases").
ALIASES: Dict[str, str] = {}  # graftlint: disable=module-mutable-state -- filled once at import by _alias(), read-only after


def _alias(canonical: str, *names: str) -> None:
    for n in names:
        ALIASES[n] = canonical


_alias("config", "config_file")
_alias("task", "task_type")
_alias("objective", "objective_type", "app", "application", "loss")
_alias("boosting", "boosting_type", "boost")
_alias("data", "train", "train_data", "train_data_file", "data_filename")
_alias("valid", "test", "valid_data", "valid_data_file", "test_data", "test_data_file", "valid_filenames")
_alias("num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
       "num_rounds", "nrounds", "num_boost_round", "n_estimators", "max_iter")
_alias("learning_rate", "shrinkage_rate", "eta")
_alias("num_leaves", "num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")
_alias("tree_learner", "tree", "tree_type", "tree_learner_type")
_alias("num_threads", "num_thread", "nthread", "nthreads", "n_jobs")
_alias("device_type", "device")
_alias("seed", "random_seed", "random_state")
_alias("max_depth", "max_tree_depth")
_alias("min_data_in_leaf", "min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf")
_alias("min_sum_hessian_in_leaf", "min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian",
       "min_child_weight")
_alias("bagging_fraction", "sub_row", "subsample", "bagging")
_alias("pos_bagging_fraction", "pos_sub_row", "pos_subsample", "pos_bagging")
_alias("neg_bagging_fraction", "neg_sub_row", "neg_subsample", "neg_bagging")
_alias("bagging_freq", "subsample_freq")
_alias("bagging_seed", "bagging_fraction_seed")
_alias("feature_fraction", "sub_feature", "colsample_bytree")
_alias("feature_fraction_bynode", "sub_feature_bynode", "colsample_bynode")
_alias("extra_trees", "extra_tree")
_alias("early_stopping_round", "early_stopping_rounds", "early_stopping", "n_iter_no_change")
_alias("lambda_l1", "reg_alpha", "l1_regularization")
_alias("lambda_l2", "reg_lambda", "lambda", "l2_regularization")
_alias("min_gain_to_split", "min_split_gain")
_alias("drop_rate", "rate_drop")
_alias("top_k", "topk")
_alias("monotone_constraints", "mc", "monotone_constraint", "monotonic_cst")
_alias("monotone_constraints_method", "monotone_constraining_method", "mc_method")
_alias("monotone_penalty", "monotone_splits_penalty", "ms_penalty", "mc_penalty")
_alias("feature_contri", "feature_contrib", "fc", "fp", "feature_penalty")
_alias("forcedsplits_filename", "fs", "forced_splits_filename", "forced_splits_file", "forced_splits")
_alias("verbosity", "verbose")
_alias("input_model", "model_input", "model_in")
_alias("output_model", "model_output", "model_out")
_alias("snapshot_freq", "save_period")
_alias("max_bin", "max_bins")
_alias("bin_construct_sample_cnt", "subsample_for_bin")
_alias("data_random_seed", "data_seed")
_alias("is_enable_sparse", "is_sparse", "enable_sparse", "sparse")
_alias("enable_bundle", "is_enable_bundle", "bundle")
_alias("pre_partition", "is_pre_partition")
_alias("two_round", "two_round_loading", "use_two_round_loading")
_alias("header", "has_header")
_alias("label_column", "label")
_alias("weight_column", "weight")
_alias("group_column", "group", "group_id", "query_column", "query", "query_id")
_alias("ignore_column", "ignore_feature", "blacklist")
_alias("categorical_feature", "cat_feature", "categorical_column", "cat_column")
_alias("save_binary", "is_save_binary", "is_save_binary_file")
_alias("predict_raw_score", "is_predict_raw_score", "predict_rawscore", "raw_score")
_alias("predict_leaf_index", "is_predict_leaf_index", "leaf_index")
_alias("predict_contrib", "is_predict_contrib", "contrib")
_alias("output_result", "predict_result", "prediction_result", "predict_name",
       "prediction_name", "pred_name", "name_pred")
_alias("num_class", "num_classes")
_alias("is_unbalance", "unbalance", "unbalanced_sets")
_alias("scale_pos_weight", "scale_pos_weight")
_alias("sigmoid", "sigmoid")
_alias("metric", "metrics", "metric_types")
_alias("metric_freq", "output_freq")
_alias("is_provide_training_metric", "training_metric", "is_training_metric", "train_metric")
_alias("eval_at", "ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")
_alias("num_machines", "num_machine")
_alias("local_listen_port", "local_port", "port")
_alias("machine_list_filename", "machine_list_file", "machine_list", "mlist")
_alias("machines", "workers", "nodes")



# Parameters the reference implements but that have no effect in this
# framework's TPU design. Each maps to (default, reason). Setting one to a
# non-default value warns ONCE with the reason (same contract as the
# `machines` warning) — nothing is silently ignored; the audit test
# (tests/test_param_audit.py) enforces that every config field is either
# consumed by the code or listed here.
NOOP_PARAMS: Dict[str, tuple] = {
    "force_col_wise": (False, "the TPU histogram layout is fixed (dense "
                       "bundled columns on the MXU one-hot path)"),
    "force_row_wise": (False, "the TPU histogram layout is fixed"),
    "is_enable_sparse": (True, "sparse inputs are EFB-bundled into the "
                         "dense matrix at construction; storage is dense"),
    "histogram_pool_size": (-1.0, "the histogram pool is leaf-count sized "
                            "in HBM; there is no host-side pool to cap"),
    "deterministic": (False, "training is already deterministic for a "
                      "fixed config on a fixed topology"),
    "num_gpu": (1, "the JAX TPU backend is used; gpu_* options select the "
                "reference's OpenCL/CUDA code paths"),
    "gpu_platform_id": (-1, "the JAX TPU backend is used"),
    "gpu_device_id": (-1, "the JAX TPU backend is used"),
    "gpu_use_dp": (False, "the JAX TPU backend is used; histograms "
                   "accumulate in float32 (tpu_hist_precision)"),
    "local_listen_port": (12400, "the reference's socket cluster port; "
                          "multi-host runs bootstrap via "
                          "parallel.distributed.init_distributed"),
    "time_out": (120, "the reference's socket timeout; jax.distributed "
                 "manages connection timeouts"),
    "machine_list_filename": ("", "the reference's socket cluster file; "
                              "use init_distributed(coordinator_address=...)"),
}

def resolve_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve aliases; canonical names win over aliases on conflict
    (mirrors python-package _ConfigAliases precedence, basic.py:258)."""
    out: Dict[str, Any] = {}
    canonical_present = set()
    for key in params:
        if key in ALIASES and ALIASES[key] != key:
            continue
        canonical_present.add(key)
    for key, value in params.items():
        canon = ALIASES.get(key, key)
        if canon != key and canon in canonical_present:
            continue  # explicit canonical setting wins
        if canon in out and key in ALIASES and ALIASES[key] != key:
            continue  # first alias wins among aliases
        out[canon] = value
    return out


# objective aliases (reference: src/objective/objective_function.cpp:15-53 name matching)
OBJECTIVE_ALIASES = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "none",
    "null": "none",
    "custom": "none",
    "na": "none",
}
